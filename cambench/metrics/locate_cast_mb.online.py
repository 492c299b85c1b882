"""Megabytes of the key file that a batch's ``locate`` calls convert to a
common type with their query keys (counter ``locate.cast_bytes``)."""
from cambench.program import counter, per_root


def read(r):
    return per_root("serving.ingest",
                    lambda s: counter(s, "locate.cast_bytes") / 1e6)
