"""Mean ms a batch spends on an RMI grid's range rows (span
``cam.profile.range``: each end at its own leaf's bound, one difference
array on the card).  A program without the span reads nothing."""
from cambench.program import ms, per_root


def read(r):
    try:
        from repro_torch import obs
    except ImportError:
        return None
    if "cam.profile.range" not in obs.snapshot()["spans"]:
        return None
    return per_root("serving.ingest", lambda s: ms(s, "cam.profile.range"))
