"""Engine executor benchmark: the fused device solve vs the host reference.

The port's twin of the JAX package's ``benchmarks/bench_engine.py``: the
same >= 10^4-cell :class:`PriceTable` (a knob-grid profile batch x a dense
per-knob capacity curve, over a mixed point+sorted workload so the full
policy-fixed-point + sorted/mixed composition runs), priced through both
executors:

* ``host``   — ``CostSession.solve_profiles`` (the golden reference), torch
  ops on the session's device: on the card they run on the card
  (``host_device`` in the record says where);
* ``device`` — the fused ``price_grid`` CUDA kernel: bisection,
  sorted/mixed composition and objective argmin in ONE launch (its plain
  torch version on CPU tensors).

Gates: float32 equivalence of every cell's hit rate (<= 2e-6), identical
distinct-page counts and winner agreement (rtol 1e-5) are asserted on both
devices.  On the card both executors are timed warm and the reference's
>= 2x speedup verdict is recorded under its key (``fused_2.0x_warm``), not
asserted: speed is recorded from chip runs and never gated.  On the CPU
the verdict is ``None`` (the kernel's plain version is what runs there).
The record is printed as the last line of standard output (JSON).

    PYTHONPATH=src python -m repro_torch.launch.bench_engine --smoke

Runs on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import json

import numpy as np

from repro_torch.core.session import (DEFAULT_TORCH_DEVICE, CostSession,
                                      GridCandidate, System,
                                      resolve_torch_device)
from repro_torch.core.workload import Workload
from repro_torch.data.workloads import (WorkloadSpec, point_workload,
                                        range_workload)
from repro_torch.engine import PriceTable, PricingEngine
from repro_torch.launch.bench_common import (GEOM, best_seconds, dataset,
                                             emit)

BUDGET = 8 << 20
N_KNOBS = 16
CAPS_PER_KNOB = 640          # 16 x 640 = 10_240 cells, every run
POLICY = "lfu"               # the heaviest kernel branch (sorts + coverage)
REPEATS = 3
GATE_SPEEDUP = 2.0


def _table(sess: CostSession, keys: np.ndarray, nq: int,
           seed: int) -> PriceTable:
    n = len(keys)
    qk, qpos = point_workload(keys, nq, WorkloadSpec("w4", seed=seed))
    _, _, rlop, rhip = range_workload(keys, max(nq // 4, 64),
                                      WorkloadSpec("w1", seed=seed + 1), 64)
    wl = Workload.mixed(Workload.point(qpos, n=n),
                        Workload.sorted_stream(np.sort(rlop), np.sort(rhip),
                                               n=n))
    eps_grid = np.unique(np.geomspace(4, 512, N_KNOBS).astype(int))
    cands = [GridCandidate(int(e), 65_536.0, eps=int(e)) for e in eps_grid]
    prof = sess.grid_profiles(cands, wl)
    cells = []
    for i, kn in enumerate(prof.knobs):
        caps = np.unique(np.geomspace(
            1, max(int(prof.caps[i]), 2), CAPS_PER_KNOB).astype(np.int64))
        caps = np.concatenate([caps, np.arange(1, CAPS_PER_KNOB
                                               - caps.shape[0] + 1)
                               + caps.max()])       # exactly CAPS_PER_KNOB
        cells.append((kn, i, caps[:CAPS_PER_KNOB]))
    return PriceTable.from_cells(prof, cells)


def run(smoke: bool = False, seed: int = 0,
        torch_device: str = DEFAULT_TORCH_DEVICE) -> dict:
    resolve_torch_device(torch_device)   # refuse a missing card first
    n, nq = (40_000, 8_000) if smoke else (200_000, 40_000)
    keys = dataset("books", n)
    sess = CostSession(System(GEOM, memory_budget_bytes=BUDGET,
                              policy=POLICY, torch_device=torch_device))
    tab = _table(sess, keys, nq, seed)
    assert len(tab) >= 10_000, len(tab)
    eng = PricingEngine(sess)

    sol_h = eng.price(tab, executor="host")
    sol_d = eng.price(tab, executor="device")
    dh = float(np.max(np.abs(sol_h.hit_rates - sol_d.hit_rates)))
    equivalent = dh < 2e-6 and np.array_equal(sol_h.distinct, sol_d.distinct)
    winner_ok = bool(np.isclose(sol_h.objective[sol_d.best_cell],
                                sol_h.objective[sol_h.best_cell],
                                rtol=1e-5, atol=1e-12))

    host_s = best_seconds(lambda: eng.price(tab, executor="host"), REPEATS)
    device_s = best_seconds(lambda: eng.price(tab, executor="device"),
                            REPEATS)
    speedup = host_s / device_s
    on_card = sess.device.type == "cuda"

    record = {
        "cells": len(tab), "rows": int(len(tab.profiles.knobs)),
        "caps_per_knob": CAPS_PER_KNOB, "n": n, "queries": nq,
        "policy": POLICY, "backend": sess.device.type,
        "torch_device": str(torch_device),
        "host_device": str(sess.device),    # the host executor's torch ops
        "fused_timed": on_card,         # the CPU runs the plain version
        "host_seconds_warm": host_s, "device_seconds_warm": device_s,
        "device_over_host_speedup": speedup,
        "max_abs_hit_rate_diff": dh, "smoke": smoke,
        "gates": {
            "float32_equivalent": bool(equivalent),
            "winner_agrees": winner_ok,
            f"fused_{GATE_SPEEDUP}x_warm": (bool(speedup >= GATE_SPEEDUP)
                                            if on_card else None),
        },
    }
    emit("engine/host", 1e6 * host_s, f"{len(tab)} cells warm")
    emit("engine/device", 1e6 * device_s,
         f"speedup={speedup:.2f}x dh={dh:.1e} "
         f"({'timed' if on_card else 'cpu: structure-only'})")

    if not equivalent:
        raise RuntimeError(f"executors diverge: max |dh| = {dh}")
    if not winner_ok:
        raise RuntimeError("fused argmin disagrees with the host winner")
    return record


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="CI-sized inputs (~seconds)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=DEFAULT_TORCH_DEVICE)
    args = ap.parse_args(argv)
    record = run(smoke=args.smoke, seed=args.seed, torch_device=args.device)
    print(json.dumps(record, default=float))
    return record


if __name__ == "__main__":
    main()
