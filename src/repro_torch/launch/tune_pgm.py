"""Memory-budgeted index tuning (paper §V) through the ONE tuning surface:
``TuningSession`` runs a joint (knob x buffer-split) search over a
declarative knob space — one batched profiling pass, one batched cache-model
solve, zero per-split model calls — while the cache-oblivious baselines plug
in as ``Tuner`` strategies.  RadixSpline shows the 2-D case: the radix table
is footprint that competes with buffer pages, so ``radix_bits`` is a real
knob under a shared budget.

The port's twin of the JAX package's ``examples/tune_pgm.py``: the same
data, budgets, grids and printed lines, run through ``repro_torch`` on a
torch device.  ``run`` also returns the numbers it prints.

    PYTHONPATH=src python -m repro_torch.launch.tune_pgm --smoke

Runs on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import json

from repro_torch.core.cam import CamGeometry
from repro_torch.core.session import (DEFAULT_TORCH_DEVICE, System,
                                      resolve_torch_device)
from repro_torch.core.workload import Workload
from repro_torch.data.datasets import make_dataset
from repro_torch.data.workloads import WorkloadSpec, point_workload
from repro_torch.sim.machine import simulate_point_queries
from repro_torch.tuning.session import (MulticriteriaTuner, PGMBuilder,
                                        RadixSplineBuilder, TuningSession)

GEOM = CamGeometry()


def run(smoke: bool = False,
        torch_device: str = DEFAULT_TORCH_DEVICE) -> dict:
    resolve_torch_device(torch_device)   # refuse a missing card first
    n, q = (200_000, 20_000) if smoke else (1_000_000, 100_000)
    keys = make_dataset("books", n, seed=1)
    qk, qpos = point_workload(keys, q, WorkloadSpec("w4", seed=3))
    workload = Workload.point(qpos, n=len(keys), query_keys=qk)
    budget = int((0.25 if smoke else 1.0) * 2**20)  # index + buffer — tight!

    print(f"memory budget: {budget / 2**20:.1f} MiB "
          "(shared by index AND buffer)")
    session = TuningSession(System(GEOM, budget, "lru",
                                   torch_device=torch_device))
    builder = PGMBuilder(keys)
    res = session.tune(builder, workload, sample_rate=0.3)
    print(f"\nCAM joint (eps x split) search ({len(res.estimates)} "
          f"candidates, {len(res.skipped)} skipped unbuilt, "
          f"{res.batched_solves} batched solve, {res.tuning_seconds:.1f}s "
          "incl. lazy size-model fit):")
    curve = {}
    for eps in sorted(res.estimates):
        e = res.estimates[eps]
        star = " <-- eps*" if eps == res.best_knob else ""
        print(f"  eps={eps:5d}: est {e.io_per_query:.4f} IO/q "
              f"(index {float(res.size_model(eps=eps))/1024:7.0f} KiB, "
              f"h={e.hit_rate:.3f}){star}")
        curve[int(eps)] = {"est_io": float(e.io_per_query),
                           "index_bytes": float(res.size_model(eps=eps)),
                           "hit_rate": float(e.hit_rate)}
    print(f"chosen buffer split: {res.split:.2f} of the budget "
          f"({res.capacity_pages} pages)")

    base = session.tune(builder, workload, tuner=MulticriteriaTuner())
    print(f"\nmulticriteria baseline (fixed 50/50 split) picks "
          f"eps={base.best_knob}")

    replayed = {}
    for name, point in [("CAM", res.best), ("baseline", base.best)]:
        adapter = builder.build(point)
        cap = max(1, (budget - adapter.size_bytes) // GEOM.page_bytes)
        plo, phi = adapter.probe_windows(qk, GEOM)
        _, qps, misses = simulate_point_queries(plo, phi, cap, "lru")
        print(f"{name:9s} eps={point['eps']:5d}: {qps:12,.0f} QPS "
              f"({misses} physical IOs)")
        replayed[name] = {"eps": int(point["eps"]), "qps": float(qps),
                          "misses": int(misses)}

    # Same session, 2-D knob space: RadixSpline's (corridor eps x
    # radix_bits).
    rs_budget = budget * 2
    rs = TuningSession(System(GEOM, rs_budget, "lru",
                              torch_device=torch_device)).tune(
        RadixSplineBuilder(keys), workload, sample_rate=0.3,
        overrides={"eps": (16, 32, 64, 128, 256, 512, 1024),
                   "radix_bits": (8, 10, 12, 14, 16)})
    print(f"\nRadixSpline under {rs_budget / 2**20:.1f} MiB: "
          f"(eps*, radix_bits*)=({rs.best['eps']}, {rs.best['radix_bits']}) "
          f"(est {rs.est_io:.4f} IO/q, {rs.tuning_seconds:.1f}s) — a narrow "
          "radix table frees buffer pages under a tight shared budget")
    return {
        "n": n, "queries": q, "budget_bytes": budget,
        "torch_device": str(torch_device),
        "cam": {"eps": int(res.best_knob), "split": float(res.split),
                "capacity_pages": int(res.capacity_pages),
                "est_io": float(res.est_io),
                "candidates": len(res.estimates),
                "skipped": len(res.skipped),
                "batched_solves": int(res.batched_solves),
                "tuning_seconds": float(res.tuning_seconds),
                "curve": curve},
        "multicriteria_eps": int(base.best_knob),
        "replayed": replayed,
        "radixspline": {"budget_bytes": rs_budget,
                        "eps": int(rs.best["eps"]),
                        "radix_bits": int(rs.best["radix_bits"]),
                        "est_io": float(rs.est_io),
                        "tuning_seconds": float(rs.tuning_seconds)},
    }


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="CI-sized inputs (~5x below the demo default)")
    ap.add_argument("--device", default=DEFAULT_TORCH_DEVICE)
    args = ap.parse_args(argv)
    out = run(smoke=args.smoke, torch_device=args.device)
    print(json.dumps(out, default=float))
    return out


if __name__ == "__main__":
    main()
