"""The reference's answer to a tune request: profiles, cells, choice."""
from __future__ import annotations

import numpy as np
import torch

from cambench.reference import cam
from cambench.reference.pgm import pgm_size_model
from cambench.reference.rmi import build_rmis, quantize_eps


def knob_sizes(inp):
    """Footprint of every knob of the grid, and the RMIs where built."""
    if inp.family == "pgm":
        model = pgm_size_model(inp.keys)
        return {e: float(model(e)) for e in inp.grid}, None
    fits = [b for b in inp.grid
            if inp.budget - (16 + 24 * b) >= inp.page_bytes]
    rmis = build_rmis(inp.keys, fits)
    return {b: float(rmis[b].size_bytes) for b in fits}, rmis


def _low(x: float, dtype) -> float:
    return float(torch.tensor(x, dtype=dtype))


def reference_entries(ctx, inp, entries, *, profile_dtype=torch.float64,
                      tf32: bool = False, price_dtype=torch.float64):
    """{entry: {"counts": {knob: (P,) tensor}, "cells": {key: (h, io,
    dac)}}} for the given pool entries.  The control passes a lower
    ``profile_dtype`` (with ``tf32``) and ``price_dtype``."""
    dev = torch.device(ctx.device)
    sizes, rmis = knob_sizes(inp)
    cells = cam.table(sizes, inp.budget, inp.page_bytes, inp.splits)
    knobs = list(dict.fromkeys(k for k, _, _ in cells))
    row = {k: i for i, k in enumerate(knobs)}
    pols = list(inp.policies) if inp.policies else [inp.policy]
    keyed = [((p, k) if inp.policies else k, k, c, p)
             for p in pols for k, _, c in cells]
    old_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    out = {}
    try:
        for entry in entries:
            positions, qk = inp.pool[entry]
            pos = torch.as_tensor(positions, device=dev)
            counts, dacs = {}, {}
            for k in knobs:
                if inp.family == "pgm":
                    counts[k] = cam.point_counts(pos, int(k), inp.c_ipp,
                                                 inp.num_pages, profile_dtype)
                    dacs[k] = _low(1.0 + 2.0 * k / inp.c_ipp, price_dtype)
                else:
                    r = rmis[k]
                    leaf = r.route(qk)
                    eps_q = quantize_eps(r.leaf_eps[leaf])
                    counts[k] = cam.mixed_counts(pos, eps_q, inp.c_ipp,
                                                 inp.num_pages, profile_dtype)
                    w = np.bincount(leaf, minlength=r.branch) / leaf.shape[0]
                    per = torch.as_tensor(1.0 + 2.0 * r.leaf_eps / inp.c_ipp,
                                          dtype=price_dtype)
                    dacs[k] = float((torch.as_tensor(w, dtype=price_dtype)
                                     * per).sum())
            stack = torch.stack([counts[k] for k in knobs])
            h = cam.hit_rates(stack, np.asarray([row[k] for _, k, _, _ in
                                                 keyed]),
                              np.asarray([c for _, _, c, _ in keyed]),
                              [p for _, _, _, p in keyed], dtype=price_dtype)
            out[entry] = {
                "counts": counts,
                "cells": {(key, c): (float(hj), (1.0 - float(hj)) * dacs[k],
                                     dacs[k])
                          for (key, k, c, _), hj in zip(keyed, h)}}
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old_tf32
    return out
