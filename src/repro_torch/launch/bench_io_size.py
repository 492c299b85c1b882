"""Table I: per-query I/O size distribution, PGM vs RMI at comparable index
sizes (osm — the weak-local-structure stress case).

The port's twin of the JAX package's ``benchmarks/bench_io_size.py``: the
same indexes and CSV lines, built by ``repro_torch``.  Every step is host
numpy (index builds and windows); ``torch_device`` is still resolved, so
the twin refuses a missing card as every entry point does.  The record
is printed as the last line of standard output (JSON).

    PYTHONPATH=src python -m repro_torch.launch.bench_io_size --smoke

Runs on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.session import (DEFAULT_TORCH_DEVICE,
                                      resolve_torch_device)
from repro_torch.data.workloads import WorkloadSpec, point_workload
from repro_torch.index.pgm import build_pgm
from repro_torch.index.rmi import build_rmi
from repro_torch.launch.bench_common import (DEFAULT_N, DEFAULT_Q, GEOM,
                                             dataset, emit, main_for)


def run(n=DEFAULT_N, n_queries=DEFAULT_Q, torch_device=DEFAULT_TORCH_DEVICE):
    resolve_torch_device(torch_device)
    keys = dataset("osm", n)
    qk, _ = point_workload(keys, n_queries, WorkloadSpec("w4", seed=3))

    idx_pgm = build_pgm(keys, eps=64)
    # match RMI size to PGM size (comparable-index-size comparison)
    branch = max(64, int(idx_pgm.size_bytes / 24))
    idx_rmi = build_rmi(keys, branch)

    record = {"n": int(n), "n_queries": int(n_queries),
              "torch_device": str(torch_device), "rows": {}}
    for name, idx in [("PGM", idx_pgm), ("RMI", idx_rmi)]:
        out = idx.window(qk)
        wlo, whi = out[0], out[1]
        pages = (whi // GEOM.c_ipp) - (wlo // GEOM.c_ipp) + 1
        io_bytes = pages * GEOM.page_bytes
        row = {"index_bytes": int(idx.size_bytes),
               "mean": float(io_bytes.mean()), "std": float(io_bytes.std()),
               **{f"p{q}": float(np.percentile(io_bytes, q))
                  for q in (50, 95, 99)}}
        emit(f"tableI/{name}", 0.0,
             f"index_bytes={idx.size_bytes}"
             f";mean={row['mean']:.1f};std={row['std']:.1f}"
             f";p50={row['p50']:.0f};p95={row['p95']:.0f}"
             f";p99={row['p99']:.0f}")
        record["rows"][f"tableI/{name}"] = row
    return record


def main(argv=None):
    return main_for(run, __doc__, argv)


if __name__ == "__main__":
    main()
