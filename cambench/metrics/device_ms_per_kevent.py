"""Device milliseconds per thousand events: the union of device activity
over whole cycles of the stream after its first (an untraced run's device
trace), per event those cycles ingest.  What the chip spends on a user's
events, read from the device's clock and so unmoved by the host's speed."""


def read(r):
    return r.busy_ms_per("event", 1000.0)
