"""Mean ms a batch spends compiling its events into a workload
(``serving.trace.compile_events``: locating every key)."""


def read(r):
    return r.span_ms("compile", per="batch")
