"""``price_grid``'s share of its roofline over the traced tune requests:
least time (``cambench.work``) over the kernel's device time."""


def read(r):
    return r.roofline_pct("price_grid")
