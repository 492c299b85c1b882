"""Mean host ms a tune request spends building its price table and
marshalling it for the card: the self ms of spans ``cam.table``
(``PriceTable`` assembly and ``cross_policies``) and ``cam.price.marshal``
(the device executor's layout and per-row statistics), that is without
their transfers (``cam.d2h``, ``cam.h2d``), which wait for the card."""
from cambench.program import ms, per_root


def read(r):
    return per_root("cam.tune", lambda s: ms(s, "cam.table", "self_ms")
                    + ms(s, "cam.price.marshal", "self_ms"))
