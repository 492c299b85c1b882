"""Table IV: CAM vs Replay vs LPM on point workloads — Q-error + time.

The port's twin of the JAX package's ``benchmarks/bench_point_accuracy.py``:
the same datasets, workloads, eps sweep, budget and CSV lines, run through
``repro_torch`` on a torch device.  CAM is called through the deprecated
``cam.estimate_point_io`` shim on purpose, inside a scoped
``warnings.catch_warnings``.

Ground truth = Replay-100 through the real buffer with windows from a BUILT
PGM (not the uniform-error model), like the paper.  Reported Q-error is on
the mean physical I/O per configuration, averaged across the eps sweep.
The record (each row's numbers) is printed as the last line of standard
output (JSON).

    PYTHONPATH=src python -m repro_torch.launch.bench_point_accuracy --smoke

Runs on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import warnings

import numpy as np

from repro_torch.core import cam, lpm
from repro_torch.core.qerror import q_error
from repro_torch.core.replay import replay_windows
from repro_torch.core.session import (DEFAULT_TORCH_DEVICE,
                                      resolve_torch_device)
from repro_torch.launch.bench_common import (DEFAULT_N, DEFAULT_Q, GEOM,
                                             Timer, emit, main_for, pgm_for,
                                             point_queries)

EPS_SWEEP = (16, 64, 256)
BUFFER_MB = 8


def _estimate(qpos, eps, n, m_budget, idx, policy, rate, torch_device):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return cam.estimate_point_io(
            qpos, eps, n, GEOM, m_budget, idx.size_bytes, policy=policy,
            sample_rate=rate, torch_device=torch_device)


def run(datasets=("books", "osm"), workloads=("w1", "w2", "w4", "w6"),
        n=DEFAULT_N, n_queries=DEFAULT_Q, policy="lru",
        torch_device=DEFAULT_TORCH_DEVICE):
    resolve_torch_device(torch_device)   # refuse a missing card first
    record = {"n": int(n), "n_queries": int(n_queries), "policy": policy,
              "torch_device": str(torch_device), "rows": {}}
    for ds in datasets:
        for wl in workloads:
            qk, qpos = point_queries(ds, wl, n, n_queries)
            results = {}
            truth = {}
            for eps in EPS_SWEEP:
                idx = pgm_for(ds, eps, n)
                m_budget = BUFFER_MB << 20
                cap = max(1, (m_budget - idx.size_bytes) // GEOM.page_bytes)
                wlo, whi = idx.window(qk)
                plo, phi = wlo // GEOM.c_ipp, whi // GEOM.c_ipp
                with Timer() as t_replay_full:
                    misses = replay_windows(plo, phi, cap, policy)
                truth[eps] = (misses.mean(), t_replay_full.seconds)

                for rate in (0.1, 1.0):
                    tag = f"CAM-{int(rate * 100)}"
                    _estimate(qpos, eps, n, m_budget, idx, policy, rate,
                              torch_device)            # warm
                    with Timer() as t:
                        est = _estimate(qpos, eps, n, m_budget, idx, policy,
                                        rate, torch_device)
                    results.setdefault(tag, []).append(
                        (est.io_per_query, t.seconds))
                    k = max(1, int(n_queries * rate))
                    with Timer() as t:
                        sel = slice(0, k)
                        m = replay_windows(plo[sel], phi[sel], cap, policy)
                    results.setdefault(f"Replay-{int(rate * 100)}", []).append(
                        (m.mean(), t.seconds))
                with Timer() as t:
                    est_lpm = lpm.lpm_estimate_from_windows(plo, phi)
                results.setdefault("LPM", []).append((est_lpm, t.seconds))

            for tag, rows in results.items():
                qerrs = [float(q_error(io, truth[eps][0]))
                         for (io, _), eps in zip(rows, EPS_SWEEP)]
                total_t = sum(t for _, t in rows)
                replay_t = sum(truth[e][1] for e in EPS_SWEEP)
                name = f"tableIV/{ds}/{wl}/{tag}"
                emit(name, total_t / len(rows) * 1e6,
                     f"mean_qerr={np.mean(qerrs):.3f}"
                     f";speedup_vs_replay100="
                     f"{replay_t / max(total_t, 1e-9):.2f}x")
                record["rows"][name] = {
                    "mean_qerr": float(np.mean(qerrs)),
                    "io": [float(io) for io, _ in rows],
                    "truth_io": [float(truth[e][0]) for e in EPS_SWEEP],
                    "seconds": total_t, "replay100_seconds": replay_t}
    return record


def main(argv=None):
    return main_for(run, __doc__, argv)


if __name__ == "__main__":
    main()
