"""Shared scaffolding of the paper-experiment twins.

The port's twin of the JAX package's ``benchmarks/common.py``: the same
default sizes (about 100x below the paper's 200M keys, regime ratios
preserved: eps/C_ipp, buffer/data, queries/pages), the same geometry, the
same dataset and PGM caches and the same query generators, made by
``repro_torch``.

Output convention: ``emit(name, us_per_call, derived)`` CSV lines.  A
timed region ends in :func:`sync`, so on the card it holds the device's
work and not only its launch.
"""
from __future__ import annotations

import argparse
import inspect
import json
import time
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.core import cam
from repro_torch.core.session import DEFAULT_TORCH_DEVICE
from repro_torch.data.datasets import make_dataset
from repro_torch.data.workloads import (WorkloadSpec, point_workload,
                                        range_workload)
from repro_torch.index.disk_layout import PageLayout
from repro_torch.index.pgm import build_pgm

DEFAULT_N = 2_000_000
DEFAULT_Q = 200_000
GEOM = cam.CamGeometry(c_ipp=256, page_bytes=4096)
LAYOUT = PageLayout(c_ipp=256, page_bytes=4096)

#: ``benchmarks/run.py --smoke``'s arguments: each twin takes those its
#: ``run`` has (about 10x below the CPU default, every code path kept).
SMOKE_KWARGS = {
    "n": 200_000,
    "n_queries": 20_000,
    "n_outer": 5_000,
    "n_pages": 50_000,
    "smoke": True,
}

_DATA_CACHE: Dict[Tuple[str, int, int], np.ndarray] = {}
_PGM_CACHE: Dict[Tuple[str, int, int, int], object] = {}


def dataset(name: str, n: int = DEFAULT_N, seed: int = 1) -> np.ndarray:
    key = (name, n, seed)
    if key not in _DATA_CACHE:
        _DATA_CACHE[key] = make_dataset(name, n, seed)
    return _DATA_CACHE[key]


def pgm_for(name: str, eps: int, n: int = DEFAULT_N, seed: int = 1):
    key = (name, eps, n, seed)
    if key not in _PGM_CACHE:
        _PGM_CACHE[key] = build_pgm(dataset(name, n, seed), eps)
    return _PGM_CACHE[key]


def point_queries(name: str, wl: str, n: int = DEFAULT_N,
                  n_queries: int = DEFAULT_Q, seed: int = 3):
    keys = dataset(name, n)
    return point_workload(keys, n_queries, WorkloadSpec(wl, seed=seed))


def range_queries(name: str, wl: str, n: int = DEFAULT_N,
                  n_queries: int = DEFAULT_Q // 4, seed: int = 3):
    keys = dataset(name, n)
    return range_workload(keys, n_queries, WorkloadSpec(wl, seed=seed),
                          max_len=2048)


def smoke_kwargs(fn) -> dict:
    """The entries of :data:`SMOKE_KWARGS` that ``fn`` takes."""
    params = inspect.signature(fn).parameters
    return {k: v for k, v in SMOKE_KWARGS.items() if k in params}


def emit(name: str, us_per_call: float, derived: str):
    print(f"{name},{us_per_call:.1f},{derived}", flush=True)


def sync() -> None:
    """Wait for the card's queued work (nothing to wait for on the CPU)."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def best_seconds(fn, repeats: int = 3) -> float:
    """The fastest of ``repeats`` warm calls of ``fn``, each ending in
    :func:`sync`."""
    fn()                                            # warm
    best = float("inf")
    for _ in range(repeats):
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        best = min(best, time.perf_counter() - t0)
    return best


class Timer:
    def __enter__(self):
        sync()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *a):
        sync()
        self.seconds = time.perf_counter() - self.t0


def main_for(run, doc: str, argv=None) -> dict:
    """The CLI of a twin whose reference has none: ``--smoke`` takes
    :data:`SMOKE_KWARGS`, ``--device`` the torch device; the record is
    printed as the last line of standard output (JSON)."""
    ap = argparse.ArgumentParser(description=doc.split("\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="CI-sized inputs (~10x below the CPU default)")
    ap.add_argument("--device", default=DEFAULT_TORCH_DEVICE)
    args = ap.parse_args(argv)
    kwargs = smoke_kwargs(run) if args.smoke else {}
    record = run(**kwargs, torch_device=args.device)
    print(json.dumps(record, default=float))
    return record
