"""Fig. 5 + Lemmas III.2/III.3: all-at-once vs one-by-one fetching.

The port's twin of the JAX package's ``benchmarks/bench_fetch_strategy.py``:
the same sweep and CSV lines, run through ``repro_torch``.

Closed-form E[DAC] vs measured page counts from a built index, plus modeled
device time under the parallel I/O model: one-by-one reads fewer pages but
issues DEPENDENT random I/Os that can't use SSD concurrency — all-at-once
wins at thread count >= ~16 (the paper's crossover).  Every step is host
work (builds, windows, the closed forms on CPU tensors); ``torch_device``
is still resolved, so the twin refuses a missing card as every entry point
does.  The record is printed as the last line of standard output (JSON).

    PYTHONPATH=src python -m repro_torch.launch.bench_fetch_strategy --smoke

Runs on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import dac
from repro_torch.core.session import (DEFAULT_TORCH_DEVICE,
                                      resolve_torch_device)
from repro_torch.data.workloads import WorkloadSpec, point_workload
from repro_torch.index.disk_layout import (fetch_all_at_once,
                                           fetch_one_by_one_counts)
from repro_torch.launch.bench_common import (DEFAULT_N, GEOM, LAYOUT, dataset,
                                             emit, main_for, pgm_for)


def run(n=DEFAULT_N, n_queries=100_000, torch_device=DEFAULT_TORCH_DEVICE):
    resolve_torch_device(torch_device)
    keys = dataset("books", n)
    qk, qpos = point_workload(keys, n_queries, WorkloadSpec("w1", seed=5))
    record = {"n": int(n), "n_queries": int(n_queries),
              "torch_device": str(torch_device), "rows": {}}
    for eps in (64, 256, 1024, 4096):
        idx = pgm_for("books", eps, n)
        wlo, whi = idx.window(qk)
        plo, phi = fetch_all_at_once(wlo, whi, LAYOUT)
        pages_aao = (phi - plo + 1).astype(np.float64)
        pages_obo = fetch_one_by_one_counts(wlo, qpos,
                                            LAYOUT).astype(np.float64)
        closed_aao = float(dac.expected_dac_all_at_once(eps, GEOM.c_ipp))
        closed_obo = float(dac.expected_dac_one_by_one(eps, GEOM.c_ipp))
        # device-time model: latency per dependent read ~80us; coalesced read
        # setup 80us + 16us/page transfer; threads hide independent I/Os.
        for threads in (1, 16, 64):
            t_aao = (80.0 + 16.0 * pages_aao.mean()) / min(threads, 64)
            t_obo = 80.0 * pages_obo.mean() / min(threads, 4)  # dependent
            name = f"fig5/eps{eps}/threads{threads}"
            emit(name, 0.0,
                 f"aao_pages={pages_aao.mean():.3f}(closed={closed_aao:.3f})"
                 f";obo_pages={pages_obo.mean():.3f}"
                 f"(closed={closed_obo:.3f})"
                 f";speedup_aao={t_obo / t_aao:.2f}x")
            record["rows"][name] = {
                "aao_pages": float(pages_aao.mean()),
                "aao_closed": closed_aao,
                "obo_pages": float(pages_obo.mean()),
                "obo_closed": closed_obo,
                "speedup_aao": float(t_obo / t_aao)}
    return record


def main(argv=None):
    return main_for(run, __doc__, argv)


if __name__ == "__main__":
    main()
