"""Events compiled and ingested per second over the untraced rest of a
traced window.  The service's throughput; it follows the host's speed,
which on the chip's machine drifts by 10-25% from minute to minute."""


def read(r):
    return r.rate("event")
