"""Kilobytes a tune request copies from the host to the card (counter
``h2d.bytes``: query positions, the price table's per-row arrays)."""
from cambench.program import counter, per_root


def read(r):
    return per_root("cam.tune", lambda s: counter(s, "h2d.bytes") / 1e3)
