"""Mean ms of one retune evaluation (``TuningSession.tune_from_profiles``
on the live window: table assembly, the ``price_grid`` launch, argmin)."""


def read(r):
    return r.span_ms("retune", per="retune")
