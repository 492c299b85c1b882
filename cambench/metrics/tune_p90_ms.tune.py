"""90th percentile of the tune requests' latencies (ms), the untraced rest
of the window: the tail beside ``tune_s``, which swings too widely with
the host's memory stalls to hold an end-to-end bound."""


def read(r):
    return r.latency_p90_ms()
