"""Mean ms a batch spends in the window sketch (``WindowSketch.update``:
the batch's profiles of every candidate and its drift summary)."""


def read(r):
    return r.span_ms("sketch", per="batch")
