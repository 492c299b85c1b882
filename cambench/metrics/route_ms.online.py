"""Mean ms a batch spends routing an RMI grid (span ``cam.route``: every
candidate's leaf bounds of the batch's point keys and of both keys of each
range).  A program without the span reads nothing."""
from cambench.program import ms, per_root


def read(r):
    try:
        from repro_torch import obs
    except ImportError:
        return None
    if "cam.route" not in obs.snapshot()["spans"]:
        return None
    return per_root("serving.ingest", lambda s: ms(s, "cam.route"))
