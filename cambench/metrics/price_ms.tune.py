"""Mean ms a tune request spends pricing its (knob x split [x policy])
table (``PricingEngine.price``: table packing, the ``price_grid``
launch, readback), device work included."""


def read(r):
    return r.span_ms("price", per="request")
