"""Batched knob-grid estimation: ``CostSession.estimate_grid`` vs the legacy
per-candidate ``estimate_point_io`` loop (the seed tuner's inner loop), over a
>= 25-candidate eps grid — plus grid-tuning all three index families through
the same session.

The port's twin of the JAX package's ``benchmarks/bench_estimate_grid.py``:
the same grids, budgets and CSV lines, run through ``repro_torch`` on a
torch device.  The legacy loop calls the deprecated ``cam`` shim on
purpose, inside a scoped ``warnings.catch_warnings``.  The record is
printed as the last line of standard output (JSON); it is written to a
file only when ``out_path`` is given.

    PYTHONPATH=src python -m repro_torch.launch.bench_estimate_grid --smoke

Runs on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import json
import time
import warnings

import numpy as np

from repro_torch.core import cam
from repro_torch.core.session import (DEFAULT_TORCH_DEVICE, CostSession,
                                      GridCandidate, System,
                                      resolve_torch_device)
from repro_torch.core.workload import Workload
from repro_torch.data.workloads import WorkloadSpec, point_workload
from repro_torch.launch.bench_common import (DEFAULT_N, GEOM, dataset, emit,
                                             main_for, sync)
from repro_torch.tuning.session import (PGMBuilder, RadixSplineBuilder,
                                        RMIBuilder, TuningSession)


def _eps_grid(k: int = 28) -> tuple:
    return tuple(int(e) for e in
                 dict.fromkeys(np.round(np.geomspace(4, 4096, k)).astype(int)))


def _timed(fn):
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, time.perf_counter() - t0


def run(n=DEFAULT_N, n_queries=100_000, budget_mb=4, out_path=None,
        torch_device=DEFAULT_TORCH_DEVICE):
    resolve_torch_device(torch_device)   # refuse a missing card first
    keys = dataset("books", n)
    qk, qpos = point_workload(keys, n_queries, WorkloadSpec("w4", seed=3))
    budget = int(budget_mb * 2**20)
    grid = _eps_grid()
    size_model = PGMBuilder(keys).size_model()
    sizes = {e: float(size_model(eps=e)) for e in grid}
    feasible = [e for e in grid if sizes[e] < budget - GEOM.page_bytes]

    def legacy_loop():
        out = {}
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            for eps in feasible:
                out[eps] = cam.estimate_point_io(
                    qpos, eps, n, GEOM, budget, sizes[eps], policy="lru",
                    torch_device=torch_device)
        return out

    def system(policy, m=budget):
        return System(GEOM, m, policy, torch_device=torch_device)

    session = CostSession(system("lru"))
    wl = Workload.point(qpos, n=n)
    cands = [GridCandidate(knob=e, eps=e, size_bytes=sizes[e]) for e in grid]

    loop_cold, loop_cold_s = _timed(legacy_loop)
    _, loop_warm_s = _timed(legacy_loop)
    res, grid_cold_s = _timed(lambda: session.estimate_grid(cands, wl))
    res, grid_warm_s = _timed(lambda: session.estimate_grid(cands, wl))

    # --- sorted-stream grid: policy-aware sorted-scan path ------------------
    # One shared (R, N, coverage, solo) profile + one batched solve; run it
    # under LFU so the frequency-aware closed form (not just the compulsory
    # Theorem III.1 form) is on the measured path.
    wlo = np.sort(qpos)
    sorted_wl = Workload.sorted_stream(
        np.maximum(wlo - 64, 0), np.minimum(wlo + 64, n - 1), n=n)
    sorted_session = CostSession(system("lfu"))
    sres, sorted_cold_s = _timed(
        lambda: sorted_session.estimate_grid(cands, sorted_wl))
    sres, sorted_warm_s = _timed(
        lambda: sorted_session.estimate_grid(cands, sorted_wl))

    rel_err = max(
        abs(res.estimates[e].io_per_query - loop_cold[e].io_per_query)
        / max(loop_cold[e].io_per_query, 1e-9)
        for e in feasible)

    # --- the same session API grid-tunes every family -----------------------
    small = min(n, 500_000)
    skeys = keys[:small]
    sqk, sqpos = point_workload(skeys, min(n_queries, 30_000),
                                WorkloadSpec("w4", seed=3))
    tuning = TuningSession(system("lru", 2 << 20))
    swl = Workload.point(sqpos, n=small, query_keys=sqk)
    pgm_res, t_pgm = _timed(lambda: tuning.tune(
        PGMBuilder(skeys), swl,
        overrides={"eps": (8, 16, 32, 64, 128, 256, 512, 1024)}))
    rmi_res, t_rmi = _timed(lambda: tuning.tune(
        RMIBuilder(skeys), swl,
        overrides={"branch": (2**8, 2**10, 2**12, 2**14)}))
    rs_res, t_rs = _timed(lambda: tuning.tune(
        RadixSplineBuilder(skeys, ref_radix_bits=12), swl,
        overrides={"eps": (16, 32, 64, 128, 256, 512, 1024),
                   "radix_bits": 12}))

    record = {
        "n": int(n),
        "n_queries": int(n_queries),
        "budget_mb": budget_mb,
        "torch_device": str(torch_device),
        "n_candidates": len(grid),
        "n_feasible": len(feasible),
        "legacy_loop_cold_seconds": loop_cold_s,
        "legacy_loop_warm_seconds": loop_warm_s,
        "estimate_grid_cold_seconds": grid_cold_s,
        "estimate_grid_warm_seconds": grid_warm_s,
        "speedup_cold": loop_cold_s / max(grid_cold_s, 1e-9),
        "speedup_warm": loop_warm_s / max(grid_warm_s, 1e-9),
        "max_rel_io_diff_vs_legacy": rel_err,
        "best_eps": int(res.best_knob),
        "sorted_grid_cold_seconds": sorted_cold_s,
        "sorted_grid_warm_seconds": sorted_warm_s,
        "sorted_grid_policy": "lfu",
        "sorted_grid_n_estimates": len(sres.estimates),
        "sorted_grid_best_eps": int(sres.best_knob),
        "families": {
            "pgm": {"knob": "eps", "best": int(pgm_res.best_knob),
                    "est_io": pgm_res.est_io, "tuning_seconds": t_pgm},
            "rmi": {"knob": "branch", "best": int(rmi_res.best_knob),
                    "est_io": rmi_res.est_io, "tuning_seconds": t_rmi},
            "radixspline": {"knob": "eps", "best": int(rs_res.best["eps"]),
                            "est_io": rs_res.est_io, "tuning_seconds": t_rs},
        },
    }
    if out_path is not None:
        with open(out_path, "w") as f:
            json.dump(record, f, indent=2)

    emit("estimate_grid/loop_cold", loop_cold_s * 1e6 / len(feasible),
         f"candidates={len(feasible)}")
    emit("estimate_grid/grid_cold", grid_cold_s * 1e6 / len(feasible),
         f"speedup={record['speedup_cold']:.1f}x")
    emit("estimate_grid/grid_warm", grid_warm_s * 1e6 / len(feasible),
         f"speedup={record['speedup_warm']:.1f}x"
         f";max_rel_diff={rel_err:.2e}")
    emit("estimate_grid/sorted_grid_warm",
         sorted_warm_s * 1e6 / max(len(sres.estimates), 1),
         f"policy=lfu;candidates={len(sres.estimates)}"
         f";best_eps={int(sres.best_knob)}")
    emit("estimate_grid/families", 0.0,
         f"pgm_eps={pgm_res.best_knob};rmi_branch={rmi_res.best_knob}"
         f";rs_eps={rs_res.best['eps']}"
         + (f";json={out_path}" if out_path is not None else ""))
    return record


def main(argv=None):
    return main_for(run, __doc__, argv)


if __name__ == "__main__":
    main()
