"""Mean ms a batch spends in the serving session's drift check (span
``serving.drift``: the window summary and its TV distance)."""
from cambench.program import ms, per_root


def read(r):
    return per_root("serving.ingest", lambda s: ms(s, "serving.drift"))
