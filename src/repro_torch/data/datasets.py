"""Synthetic key distributions shaped after the SOSD benchmark datasets
(books / fb / osm / wiki) the paper evaluates on (§VII-A).

Each generator produces sorted, distinct uint64 keys via cumulative sums of
positive gap samples whose law mimics the real dataset's local structure:

* books — Amazon sales ranks: lognormal gaps (moderate heavy tail).
* fb    — Facebook user ids: Pareto gaps (extreme heavy tail → hard-to-fit
          regions, large PLA segments variance).
* osm   — OpenStreetMap cell ids: dense clusters split by huge jumps (weak
          local structure — the paper's stress case, Table I).
* wiki  — edit timestamps: near-uniform with bursty regions.

Scaled down from the paper's 200M keys (CPU container); generators accept any
``n`` so the benchmarks can grow with ``--scale``.
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np

__all__ = ["make_dataset", "DATASETS"]


def _finalize(gaps: np.ndarray) -> np.ndarray:
    gaps = np.maximum(gaps.astype(np.uint64), 1)
    keys = np.cumsum(gaps)
    # cumsum of positive gaps is strictly increasing => already distinct/sorted
    return keys.astype(np.uint64)


def _books(n: int, rng: np.random.Generator) -> np.ndarray:
    gaps = rng.lognormal(mean=1.0, sigma=2.0, size=n)
    return _finalize(np.minimum(gaps, 1e9))


def _fb(n: int, rng: np.random.Generator) -> np.ndarray:
    gaps = rng.pareto(a=1.05, size=n) + 1.0
    return _finalize(np.minimum(gaps, 1e12))


def _osm(n: int, rng: np.random.Generator) -> np.ndarray:
    # Clusters of ~geometric(1/800) length with tiny in-cluster gaps and huge
    # inter-cluster jumps.
    n_clusters = max(2, n // 800)
    boundaries = np.sort(rng.choice(n - 1, size=n_clusters, replace=False))
    gaps = rng.integers(1, 4, size=n).astype(np.float64)
    jumps = rng.pareto(a=0.8, size=n_clusters) * 1e6 + 1e5
    gaps[boundaries] += np.minimum(jumps, 1e13)
    return _finalize(gaps)


def _wiki(n: int, rng: np.random.Generator) -> np.ndarray:
    # Doubly-stochastic exponential gaps: slowly varying burst rate.
    n_phases = max(2, n // 5000)
    rates = rng.lognormal(0.0, 1.0, size=n_phases)
    phase = np.repeat(rates, -(-n // n_phases))[:n]
    gaps = rng.exponential(scale=50.0, size=n) / phase + 1.0
    return _finalize(np.minimum(gaps, 1e9))


DATASETS: Dict[str, Callable[[int, np.random.Generator], np.ndarray]] = {
    "books": _books,
    "fb": _fb,
    "osm": _osm,
    "wiki": _wiki,
}


def make_dataset(name: str, n: int, seed: int = 0) -> np.ndarray:
    """Sorted distinct uint64 keys of the named synthetic family."""
    try:
        gen = DATASETS[name]
    except KeyError:
        raise ValueError(f"unknown dataset {name!r}; one of {sorted(DATASETS)}") from None
    return gen(n, np.random.default_rng(seed))
