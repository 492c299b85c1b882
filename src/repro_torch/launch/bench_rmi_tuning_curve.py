"""Fig. 8: CAM-estimated vs actual I/O for RMI across branch factors —
the sharp right-edge rise when the index squeezes out the buffer.

The port's twin of the JAX package's ``benchmarks/bench_rmi_tuning_curve.py``:
the same grid, budgets, policies and CSV lines, run through ``repro_torch``
on a torch device.

The branch grid prices through ONE ``TuningSession.tune`` call per
(policy, budget): the prebuilt candidates profile through the batched
mixed-eps kernel (one grouped pass for the whole grid, ``profile_grid`` on
the card) and all hit rates solve in one batched pass.  The record (each
curve's numbers) is printed as the last line of standard output (JSON).

    PYTHONPATH=src python -m repro_torch.launch.bench_rmi_tuning_curve --smoke

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
from repro_torch.index.adapters import RMIAdapter
from repro_torch.index.rmi import build_rmi
from repro_torch.launch.bench_common import (DEFAULT_N, GEOM, dataset, emit,
                                             main_for)
from repro_torch.tuning.session import RMIBuilder, TuningSession

BRANCH_GRID = (2**8, 2**10, 2**12, 2**14, 2**16)


def run(n=DEFAULT_N, n_queries=100_000, budgets_mb=(2, 4),
        torch_device=DEFAULT_TORCH_DEVICE):
    resolve_torch_device(torch_device)   # refuse a missing card first
    keys = dataset("books", n)
    qk, qpos = point_workload(keys, n_queries, WorkloadSpec("w4", seed=3))
    wl = Workload.point(qpos, n=n, query_keys=qk)
    builder = RMIBuilder(keys)
    builder.built = {b: RMIAdapter(build_rmi(keys, b)) for b in BRANCH_GRID}
    record = {"n": int(n), "n_queries": int(n_queries),
              "torch_device": str(torch_device), "curves": {}}
    for policy in ("lru", "fifo"):
        for mem_mb in budgets_mb:
            m_budget = mem_mb << 20
            session = TuningSession(System(GEOM, m_budget, policy,
                                           torch_device=torch_device))
            try:
                res = session.tune(builder, wl,
                                   overrides={"branch": BRANCH_GRID})
            except ValueError:
                continue  # budget below every candidate's footprint
            curve_est = {b: est.io_per_query
                         for b, est in res.estimates.items()}
            curve_act = {}
            for b in curve_est:
                idx = builder.built[b].index
                cap = max(1, (m_budget - idx.size_bytes) // GEOM.page_bytes)
                wlo, whi, _ = idx.window(qk)
                misses = replay_windows(wlo // GEOM.c_ipp, whi // GEOM.c_ipp,
                                        cap, policy)
                curve_act[b] = float(misses.mean())
            best_est = res.best_knob
            best_act = min(curve_act, key=curve_act.get)
            qerrs = [float(q_error(curve_est[b], curve_act[b]))
                     for b in curve_est]
            name = f"fig8/{policy}/{mem_mb}MB"
            emit(name, res.tuning_seconds * 1e6 / max(len(curve_est), 1),
                 f"branch_star_cam={best_est};branch_star_actual={best_act}"
                 f";curve_qerr={np.mean(qerrs):.3f}")
            record["curves"][name] = {
                "branch_star_cam": int(best_est),
                "branch_star_actual": int(best_act),
                "curve_qerr": float(np.mean(qerrs)),
                "est_io": {int(b): float(v) for b, v in curve_est.items()},
                "replay_io": {int(b): v for b, v in curve_act.items()},
                "tuning_seconds": res.tuning_seconds}
    return record


def main(argv=None):
    return main_for(run, __doc__, argv)


if __name__ == "__main__":
    main()
