"""Table II: relative contribution of Cov(H, DAC) to E[IO] across policies,
eps, and memory budgets — the justification for dropping the covariance term
in Eq. 3 (paper finds |r| <= ~3.7%).

The port's twin of the JAX package's ``benchmarks/bench_covariance.py``:
the same sweep and CSV lines, run through ``repro_torch``.  Every step is
host numpy (builds and replay); ``torch_device`` is still resolved, so the
twin refuses a missing card as every entry point does.  The record is
printed as the last line of standard output (JSON).

    PYTHONPATH=src python -m repro_torch.launch.bench_covariance --smoke

Runs on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.replay import replay_windows
from repro_torch.core.session import (DEFAULT_TORCH_DEVICE,
                                      resolve_torch_device)
from repro_torch.data.workloads import WorkloadSpec, point_workload
from repro_torch.launch.bench_common import (DEFAULT_N, GEOM, dataset, emit,
                                             main_for, pgm_for)


def run(n=DEFAULT_N, n_queries=100_000, torch_device=DEFAULT_TORCH_DEVICE):
    resolve_torch_device(torch_device)
    keys = dataset("books", n)
    qk, _ = point_workload(keys, n_queries, WorkloadSpec("w4", seed=3))
    record = {"n": int(n), "n_queries": int(n_queries),
              "torch_device": str(torch_device), "rows": {}}
    for policy in ("fifo", "lru", "lfu"):
        for eps in (8, 16, 64):
            idx = pgm_for("books", eps, n)
            for mem_mb in (2, 4, 6):
                cap = max(1, ((mem_mb << 20) - idx.size_bytes)
                          // GEOM.page_bytes)
                wlo, whi = idx.window(qk)
                plo, phi = wlo // GEOM.c_ipp, whi // GEOM.c_ipp
                dac = (phi - plo + 1).astype(np.float64)
                misses = replay_windows(plo, phi, cap,
                                        policy).astype(np.float64)
                hit_frac = 1.0 - misses / dac
                e_io = misses.mean()
                # E[IO] = (1-E[H])E[DAC] - Cov(H, DAC)  (Eq. 2)
                cov = np.mean(hit_frac * dac) - hit_frac.mean() * dac.mean()
                r = -cov / max(e_io, 1e-12) * 100.0
                name = f"tableII/{policy}/eps{eps}/{mem_mb}MB"
                emit(name, 0.0, f"E_IO={e_io:.3f};r_pct={r:.3f}")
                record["rows"][name] = {"E_IO": float(e_io),
                                        "r_pct": float(r)}
    return record


def main(argv=None):
    return main_for(run, __doc__, argv)


if __name__ == "__main__":
    main()
