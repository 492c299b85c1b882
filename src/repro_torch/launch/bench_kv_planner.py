"""Beyond-paper: CAM-guided KV-pool planner accuracy — structural
closed-form vs IRM (Che) vs PagedKVPool replay across HBM budgets (the
Eq. 15 analogue on the serving plane).

The port's twin of the JAX package's ``benchmarks/bench_kv_planner.py``:
the same request mix, schedule, budgets and printed lines, run through
``repro_torch`` (``serve.planner``, ``serve.kv_cache`` and
``core.cache_models.hit_rate`` on a torch device, without the Che kernel,
as the reference prices it without one).  ``struct_err`` and ``irm_err``
are recorded, not gated, as in the reference.  The record is printed as
the last line of standard output (JSON).

    PYTHONPATH=src python -m repro_torch.launch.bench_kv_planner

Runs on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import cache_models
from repro_torch.core.session import (DEFAULT_TORCH_DEVICE,
                                      resolve_torch_device)
from repro_torch.launch.bench_common import emit, main_for
from repro_torch.serve.kv_cache import BlockTrace, PagedKVPool
from repro_torch.serve.planner import (RequestMix, block_popularity,
                                       structural_hit_rate)

POOL_FRACS = (0.2, 0.4, 0.6, 0.9, 1.2)


def run(torch_device=DEFAULT_TORCH_DEVICE) -> dict:
    dev = resolve_torch_device(torch_device)   # refuse a missing card first
    mix = RequestMix(n_requests=24, shared_prefix=1024, mean_context=2048,
                     decode_steps=16, kv_bytes_per_token=1024)
    bt = 64
    probs, refs = block_popularity(mix, bt)
    n_distinct = probs.shape[0]
    rng = np.random.default_rng(0)
    schedule = [(int(r), mix.shared_prefix, mix.mean_context)
                for _ in range(mix.decode_steps)
                for r in rng.permutation(mix.n_requests)]
    trace = BlockTrace(bt).decode_trace(schedule)
    probs_t = torch.as_tensor(np.asarray(probs), dtype=torch.float32,
                              device=dev)

    rows = {}
    for frac in POOL_FRACS:
        pool_blocks = max(1, int(n_distinct * frac))
        pool = PagedKVPool(pool_blocks, bt, 1024 * bt)
        for ref in trace:
            pool.reference(ref)
        h_struct = (structural_hit_rate(mix, bt, pool_blocks)
                    if pool_blocks < n_distinct else pool.hit_rate)
        h_irm = float(cache_models.hit_rate(
            "lru", min(pool_blocks, n_distinct - 1), probs_t,
            total_requests=len(trace)))
        name = f"pool{frac:.1f}N"
        emit(f"kv_planner/{name}", 0.0,
             f"replay={pool.hit_rate:.3f};structural={h_struct:.3f}"
             f";irm_che={h_irm:.3f}"
             f";struct_err={abs(h_struct - pool.hit_rate):.3f}"
             f";irm_err={abs(h_irm - pool.hit_rate):.3f}")
        rows[name] = {"pool_blocks": pool_blocks,
                      "replay": float(pool.hit_rate),
                      "structural": float(h_struct), "irm_che": h_irm,
                      "struct_err": float(abs(h_struct - pool.hit_rate)),
                      "irm_err": float(abs(h_irm - pool.hit_rate))}
    return {"distinct_blocks": int(n_distinct), "references": len(trace),
            "block_tokens": bt, "torch_device": str(torch_device),
            "rows": rows}


def main(argv=None):
    return main_for(run, __doc__, argv)


if __name__ == "__main__":
    main()
