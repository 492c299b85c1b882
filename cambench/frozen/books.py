"""Synthetic SOSD-``books``-shaped keys.

Frozen copy of ``repro_torch.data.datasets`` (``_finalize``, ``_books``) at
commit 841dd630a0202e497cba3d6a4c1d3efa933a6491: sorted, distinct uint64
keys from the cumulative sum of lognormal(1, 2) gaps capped at 1e9.
"""
from __future__ import annotations

import numpy as np


def books_keys(n: int, rng: np.random.Generator) -> np.ndarray:
    gaps = np.minimum(rng.lognormal(mean=1.0, sigma=2.0, size=n), 1e9)
    gaps = np.maximum(gaps.astype(np.uint64), 1)
    return np.cumsum(gaps).astype(np.uint64)
