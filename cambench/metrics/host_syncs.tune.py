"""Transfers a tune request makes that block the host on the card (counter
``sync.count``): reads from the card and uploads from host memory."""
from cambench.program import counter, per_root


def read(r):
    return per_root("cam.tune", lambda s: counter(s, "sync.count"))
