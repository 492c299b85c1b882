"""``profile_grid``'s share of its roofline over the traced batches (the
RMI grid's point rows): least time (``cambench.work``) over device time."""


def read(r):
    return r.roofline_pct("profile_grid")
