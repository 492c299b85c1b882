"""Share of the traced tune window in which nothing ran on the device."""


def read(r):
    return r.idle_pct()
