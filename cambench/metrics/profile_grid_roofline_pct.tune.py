"""``profile_grid``'s share of its roofline over the traced tune requests
(RMI profiling): least time (``cambench.work``) over device time."""


def read(r):
    return r.roofline_pct("profile_grid")
