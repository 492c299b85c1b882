"""Fig. 7: CAM-estimated vs actual I/O across eps and eviction policies under
memory budgets — the U-shaped index-footprint/buffer trade-off.

The port's twin of the JAX package's ``benchmarks/bench_pgm_tuning_curve.py``:
the same grid, budgets, policies and CSV lines, run through ``repro_torch``
on a torch device.

Each (policy, budget) curve prices through ONE ``TuningSession.tune`` call
(the joint knob x split search over batched profiles); the per-knob
estimates at full capacity ARE the curve.  Replay ground truth is unchanged;
``TableSizeModel`` pins the session to the built indexes' exact footprints
so estimated and replayed capacities agree bit-for-bit.  The record (each
curve's numbers) is printed as the last line of standard output (JSON).

    PYTHONPATH=src python -m repro_torch.launch.bench_pgm_tuning_curve --smoke

Runs on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.qerror import q_error
from repro_torch.core.replay import replay_windows
from repro_torch.core.session import (DEFAULT_TORCH_DEVICE, System,
                                      resolve_torch_device)
from repro_torch.core.workload import Workload
from repro_torch.data.workloads import WorkloadSpec, point_workload
from repro_torch.launch.bench_common import (DEFAULT_N, GEOM, dataset, emit,
                                             main_for, pgm_for)
from repro_torch.tuning.session import (PGMBuilder, TableSizeModel,
                                        TuningSession)

EPS_GRID = (8, 16, 32, 64, 128, 256, 512, 1024)


def run(n=DEFAULT_N, n_queries=100_000, budgets_mb=(2, 4, 6),
        torch_device=DEFAULT_TORCH_DEVICE):
    resolve_torch_device(torch_device)   # refuse a missing card first
    keys = dataset("books", n)
    qk, qpos = point_workload(keys, n_queries, WorkloadSpec("w4", seed=3))
    wl = Workload.point(qpos, n=n)
    indexes = {eps: pgm_for("books", eps, n) for eps in EPS_GRID}
    sizes = TableSizeModel({e: float(i.size_bytes)
                            for e, i in indexes.items()})
    builder = PGMBuilder(keys)
    record = {"n": int(n), "n_queries": int(n_queries),
              "torch_device": str(torch_device), "curves": {}}
    for policy in ("fifo", "lru", "lfu"):
        for mem_mb in budgets_mb:
            m_budget = mem_mb << 20
            session = TuningSession(System(GEOM, m_budget, policy,
                                           torch_device=torch_device))
            res = session.tune(builder, wl, overrides={"eps": EPS_GRID},
                               size_model=sizes)
            curve_est = {eps: est.io_per_query
                         for eps, est in res.estimates.items()}
            curve_act = {}
            for eps in curve_est:
                idx = indexes[eps]
                cap = max(1, (m_budget - idx.size_bytes) // GEOM.page_bytes)
                wlo, whi = idx.window(qk)
                misses = replay_windows(wlo // GEOM.c_ipp, whi // GEOM.c_ipp,
                                        cap, policy)
                curve_act[eps] = float(misses.mean())
            best_est = res.best_knob
            best_act = min(curve_act, key=curve_act.get)
            qerrs = [float(q_error(curve_est[e], curve_act[e]))
                     for e in curve_est]
            name = f"fig7/{policy}/{mem_mb}MB"
            emit(name, res.tuning_seconds * 1e6 / max(len(curve_est), 1),
                 f"eps_star_cam={best_est};eps_star_actual={best_act}"
                 f";curve_qerr={np.mean(qerrs):.3f}"
                 f";ushaped={int(_is_ushaped(curve_act))}")
            record["curves"][name] = {
                "eps_star_cam": int(best_est),
                "eps_star_actual": int(best_act),
                "curve_qerr": float(np.mean(qerrs)),
                "ushaped": int(_is_ushaped(curve_act)),
                "est_io": {int(e): float(v) for e, v in curve_est.items()},
                "replay_io": {int(e): v for e, v in curve_act.items()},
                "tuning_seconds": res.tuning_seconds}
    return record


def _is_ushaped(curve):
    eps_sorted = sorted(curve)
    vals = [curve[e] for e in eps_sorted]
    best = int(np.argmin(vals))
    return vals[-1] > vals[best] or vals[0] > vals[best]


def main(argv=None):
    return main_for(run, __doc__, argv)


if __name__ == "__main__":
    main()
