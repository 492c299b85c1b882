"""Figs. 9/10: end-to-end tuner comparison — throughput of the configuration
each tuner picks under a shared memory budget, plus tuning time.

The port's twin of the JAX package's ``benchmarks/bench_tuning_e2e.py``:
the same dataset, workload, grids, budgets and CSV lines, run through
``repro_torch`` on a torch device.

Everything tunes through ONE surface (``TuningSession``): CAM is the joint
(knob x buffer-split) search; the cache-oblivious baselines
(multicriteria-PGM, CDFShop) are pluggable ``Tuner`` strategies that
reserve a fixed buffer fraction and profile candidates in the remainder.
Three records:

* ``pgm``/``rmi`` — CAM-vs-multicriteria and CAM-vs-CDFShop replayed-QPS
  ratios per budget (the paper reports 1.17x and 1.66x);
* ``radixspline_joint`` — jointly tuned (eps, radix_bits) vs eps-only tuning
  at the legacy fixed radix_bits=16 (the table competes with buffer pages);
* ``mixed_eps_kernel`` — the batched grouped kernel pricing a full RMI
  branch grid vs the per-branch mixture-histogram path (warm, same grid,
  same solve; the reference names a 3x gate, recorded here, not asserted).

The record is printed as the last line of standard output (JSON); it is
written to a file only when ``out_path`` is given.

    PYTHONPATH=src python -m repro_torch.launch.bench_tuning_e2e --smoke

Runs on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import json
import time

from repro_torch.core.session import (DEFAULT_TORCH_DEVICE, CostSession,
                                      GridCandidate, System,
                                      resolve_torch_device)
from repro_torch.core.workload import Workload
from repro_torch.data.workloads import WorkloadSpec, point_workload
from repro_torch.index.adapters import DEFAULT_BRANCH_GRID
from repro_torch.launch.bench_common import (DEFAULT_N, GEOM, dataset, emit,
                                             sync)
from repro_torch.sim.machine import simulate_point_queries
from repro_torch.tuning.session import (CDFShopTuner, MulticriteriaTuner,
                                        PGMBuilder, RadixSplineBuilder,
                                        RMIBuilder, TuningSession)

RMI_GRID = (2**8, 2**10, 2**12, 2**14, 2**16)
RS_EPS_GRID = (16, 32, 64, 128, 256, 512, 1024)
RS_BITS_GRID = (8, 10, 12, 14, 16)


def _qps(builder, point, qk, m_budget, policy="lru"):
    """Replayed throughput of one tuned configuration (ground truth)."""
    adapter = builder.build(point)
    cap = max(1, (m_budget - adapter.size_bytes) // GEOM.page_bytes)
    plo, phi = adapter.probe_windows(qk, GEOM)
    _, qps, misses = simulate_point_queries(plo, phi, cap, policy)
    return qps, misses


def _mixed_eps_ab(keys, wl, budget, torch_device, reps=5):
    """Warm A/B: batched grouped kernel vs per-branch mixture histograms."""
    builder = RMIBuilder(keys)
    session = CostSession(System(GEOM, budget, "lru",
                                 torch_device=torch_device))
    cands = []
    for b in DEFAULT_BRANCH_GRID:
        adapter = builder.build({"branch": b})
        cands.append(GridCandidate(knob=b, size_bytes=adapter.size_bytes,
                                   index=adapter))
    out = {}
    for label, flag in (("batched", True), ("per_branch", False)):
        session.estimate_grid(cands, wl, sample_rate=0.3,
                              batch_mixed_eps=flag)      # warm-up
        times = []
        for _ in range(reps):
            sync()
            t0 = time.perf_counter()
            res = session.estimate_grid(cands, wl, sample_rate=0.3,
                                        batch_mixed_eps=flag)
            sync()
            times.append(time.perf_counter() - t0)
        out[label] = min(times)
        out[f"{label}_best_branch"] = int(res.best_knob)
    out["speedup_warm"] = out["per_branch"] / max(out["batched"], 1e-9)
    out["n_candidates"] = len(cands)
    return out


def run(n=DEFAULT_N, n_queries=100_000,
        budgets_mb=(0.5, 0.8, 1.0, 1.5, 2, 3.5), out_path=None,
        torch_device=DEFAULT_TORCH_DEVICE):
    resolve_torch_device(torch_device)   # refuse a missing card first
    keys = dataset("books", n)
    qk, qpos = point_workload(keys, n_queries, WorkloadSpec("w4", seed=3))
    wl = Workload.point(qpos, n=len(keys), query_keys=qk)

    # Builders are shared across budgets: size models fit once, candidate
    # indexes build once (the session re-prices them per budget).
    pgm_b, rmi_b, rs_b = PGMBuilder(keys), RMIBuilder(keys), \
        RadixSplineBuilder(keys)
    record = {"n": int(n), "n_queries": int(n_queries), "budgets": {},
              "torch_device": str(torch_device)}

    for mem_mb in budgets_mb:
        m = int(mem_mb * 2**20)
        ts = TuningSession(System(GEOM, m, "lru", torch_device=torch_device))
        entry = {}

        # --- PGM: CAM joint search vs multicriteria baseline
        res = ts.tune(pgm_b, wl, sample_rate=0.3)
        qps_cam, _ = _qps(pgm_b, res.best, qk, m)
        base = ts.tune(pgm_b, wl, tuner=MulticriteriaTuner())
        qps_base, _ = _qps(pgm_b, base.best, qk, m)
        entry["pgm"] = {
            "cam_eps": int(res.best_knob), "cam_qps": qps_cam,
            "multicriteria_eps": int(base.best_knob),
            "multicriteria_qps": qps_base,
            "qps_gain": qps_cam / max(qps_base, 1),
            "cam_split": res.split,
            "tuning_time_ratio": res.tuning_seconds
            / max(base.tuning_seconds, 1e-9),
        }
        emit(f"fig9/pgm/{mem_mb}MB", res.tuning_seconds * 1e6,
             f"cam_eps={res.best_knob};cam_qps={qps_cam:.0f}"
             f";base_eps={base.best_knob};base_qps={qps_base:.0f}"
             f";qps_gain={qps_cam / max(qps_base, 1):.2f}x")

        # --- RMI: CAM (batched mixed-eps grid) vs CDFShop baseline
        rres = ts.tune(rmi_b, wl, overrides={"branch": RMI_GRID},
                       sample_rate=0.3)
        qps_rmi, _ = _qps(rmi_b, rres.best, qk, m)
        cdf = ts.tune(rmi_b, wl, tuner=CDFShopTuner(),
                      overrides={"branch": RMI_GRID})
        qps_cdf, _ = _qps(rmi_b, cdf.best, qk, m)
        entry["rmi"] = {
            "cam_branch": int(rres.best_knob), "cam_qps": qps_rmi,
            "cdfshop_branch": int(cdf.best_knob), "cdfshop_qps": qps_cdf,
            "qps_gain": qps_rmi / max(qps_cdf, 1),
            "skipped_unbuilt": [int(s.knob) for s in rres.skipped],
        }
        emit(f"fig10/rmi/{mem_mb}MB", rres.tuning_seconds * 1e6,
             f"cam_branch={rres.best_knob};cam_qps={qps_rmi:.0f}"
             f";cdfshop_branch={cdf.best_knob};cdfshop_qps={qps_cdf:.0f}"
             f";qps_gain={qps_rmi / max(qps_cdf, 1):.2f}x")

        # --- RadixSpline: joint (eps, radix_bits) vs eps-only at bits=16
        try:
            joint = ts.tune(rs_b, wl, sample_rate=0.3,
                            overrides={"eps": RS_EPS_GRID,
                                       "radix_bits": RS_BITS_GRID})
            eps_only = ts.tune(rs_b, wl, sample_rate=0.3,
                               overrides={"eps": RS_EPS_GRID,
                                          "radix_bits": 16})
        except ValueError:
            record["budgets"][str(mem_mb)] = entry
            continue  # budget below the eps-only radix-table floor
        qps_joint, _ = _qps(rs_b, joint.best, qk, m)
        qps_eps_only, _ = _qps(rs_b, eps_only.best, qk, m)
        entry["radixspline_joint"] = {
            "joint_eps": int(joint.best["eps"]),
            "joint_radix_bits": int(joint.best["radix_bits"]),
            "joint_qps": qps_joint,
            "eps_only_eps": int(eps_only.best["eps"]),
            "eps_only_qps": qps_eps_only,
            "qps_gain": qps_joint / max(qps_eps_only, 1),
        }
        emit(f"fig10b/radixspline/{mem_mb}MB", joint.tuning_seconds * 1e6,
             f"joint=({joint.best['eps']},{joint.best['radix_bits']})"
             f";joint_qps={qps_joint:.0f};eps_only_qps={qps_eps_only:.0f}"
             f";qps_gain={qps_joint / max(qps_eps_only, 1):.2f}x")
        record["budgets"][str(mem_mb)] = entry

    # --- the batched mixed-eps kernel vs the per-branch path (warm)
    ab_budget = int(max(budgets_mb) * 2**20) + (2 << 20)
    record["mixed_eps_kernel"] = _mixed_eps_ab(keys, wl, ab_budget,
                                               torch_device)
    emit("tuning_e2e/mixed_eps_kernel",
         record["mixed_eps_kernel"]["batched"] * 1e6,
         f"speedup_warm={record['mixed_eps_kernel']['speedup_warm']:.2f}x"
         f";candidates={record['mixed_eps_kernel']['n_candidates']}")

    if out_path is not None:
        with open(out_path, "w") as f:
            json.dump(record, f, indent=2)
        emit("tuning_e2e/json", 0.0, f"path={out_path}")
    return record


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="CI-sized inputs (~10x below the CPU default)")
    ap.add_argument("--device", default=DEFAULT_TORCH_DEVICE)
    args = ap.parse_args(argv)
    kw = (dict(n=200_000, n_queries=20_000, budgets_mb=(0.5, 1.0))
          if args.smoke else {})
    record = run(**kw, torch_device=args.device)
    print(json.dumps(record, default=float))
    return record


if __name__ == "__main__":
    main()
