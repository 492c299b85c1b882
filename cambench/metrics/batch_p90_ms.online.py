"""90th percentile of the batches' compile + ingest latencies (ms), the
untraced rest of the window: the tail beside ``events_per_s``, which swings
too widely with the host's memory stalls to hold an end-to-end bound."""


def read(r):
    return r.latency_p90_ms()
