"""Mean self ms of a tune request's root span ``cam.tune``
(``TuningSession.tune``) outside its children (profiling, table assembly,
pricing): feasibility, candidates, the result's assembly.  In the traced
window it also holds the harness's own wraps of ``grid_profiles`` and
``PricingEngine.price``, which sit inside ``cam.tune`` but outside
``cam.profile`` and ``cam.price``: their profiler ranges and device
synchronizes."""
from cambench.program import ms, per_root


def read(r):
    return per_root("cam.tune", lambda s: ms(s, "cam.tune", "self_ms"))
