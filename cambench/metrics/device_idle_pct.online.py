"""Share of the traced serving window in which nothing ran on the device."""


def read(r):
    return r.idle_pct()
