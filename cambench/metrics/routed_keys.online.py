"""Keys an RMI grid routes a batch (counter ``route.keys``: point keys and
range endpoints, summed over the candidates).  A program without the
counter reads nothing."""
from cambench.program import counter, per_root


def read(r):
    try:
        from repro_torch import obs
    except ImportError:
        return None
    if "route.keys" not in obs.snapshot()["counters"]:
        return None
    return per_root("serving.ingest", lambda s: counter(s, "route.keys"))
