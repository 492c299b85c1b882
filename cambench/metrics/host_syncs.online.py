"""Transfers a batch makes that block the host on the card (counter
``sync.count``): reads from the card and uploads from host memory."""
from cambench.program import counter, per_root


def read(r):
    return per_root("serving.ingest", lambda s: counter(s, "sync.count"))
