"""Mean ms a tune request's host spends in transfers that block on the card
(spans ``cam.d2h`` and ``cam.h2d``): the wait for the work queued before
each read or upload, and the copy."""
from cambench.program import ms, per_root


def read(r):
    return per_root("cam.tune", lambda s: ms(s, "cam.d2h") + ms(s, "cam.h2d"))
