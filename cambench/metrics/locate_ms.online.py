"""Mean ms a batch spends in ``core.workload.locate`` (span
``cam.locate``: every ``searchsorted`` that ``compile_events`` makes)."""
from cambench.program import ms, per_root


def read(r):
    return per_root("serving.ingest", lambda s: ms(s, "cam.locate"))
