"""Mean ms a tune request spends profiling its candidates
(``CostSession.grid_profiles``: ``core/page_ref.py``, index prediction,
``kernels/profile_grid``), device work included."""


def read(r):
    return r.span_ms("profile", per="request")
