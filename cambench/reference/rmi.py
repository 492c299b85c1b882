"""Two-layer RMIs over the benchmark's keys, and the queries' leaf errors.

Frozen copy of ``repro_torch.index.rmi.build_rmi`` (root and per-leaf
least squares, per-leaf empirical max error) and of its ``route`` at
commit 841dd630a0202e497cba3d6a4c1d3efa933a6491; the per-leaf maximum is
taken with ``maximum.reduceat`` over the router's contiguous leaf ranges,
which gives the same integers as the original ``maximum.at``.  Branches
build in threads (NumPy releases the interpreter lock in array work).
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
from typing import Dict, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class RMI:
    root_slope: float
    root_intercept: float
    branch: int
    leaf_eps: np.ndarray        # (branch,) int64 empirical max abs error
    n: int

    @property
    def size_bytes(self) -> int:
        return 16 + 24 * self.branch

    def route(self, query_keys: np.ndarray) -> np.ndarray:
        pos = self.root_slope * np.asarray(query_keys).astype(np.float64) \
            + self.root_intercept
        leaf = np.floor(pos * self.branch / max(self.n, 1)).astype(np.int64)
        return np.clip(leaf, 0, self.branch - 1)


def _root(kf: np.ndarray):
    n = kf.shape[0]
    ranks = np.arange(n, dtype=np.float64)
    kc = kf - kf.mean()
    denom = float((kc * kc).sum())
    slope = float((kc * ranks).sum() / denom) if denom > 0 else 0.0
    return slope, float(ranks.mean() - slope * kf.mean())


def _build(kf: np.ndarray, root, branch: int) -> RMI:
    n = kf.shape[0]
    ranks = np.arange(n, dtype=np.float64)
    root_slope, root_intercept = root
    leaf = np.clip(np.floor((root_slope * kf + root_intercept) * branch / n)
                   .astype(np.int64), 0, branch - 1)
    cnt = np.bincount(leaf, minlength=branch).astype(np.float64)
    first_idx = np.searchsorted(leaf, np.arange(branch), side="left")
    x0 = kf[np.clip(first_idx, 0, n - 1)]
    xc = kf - x0[leaf]
    sx = np.bincount(leaf, weights=xc, minlength=branch)
    sy = np.bincount(leaf, weights=ranks, minlength=branch)
    sxx = np.bincount(leaf, weights=xc * xc, minlength=branch)
    sxy = np.bincount(leaf, weights=xc * ranks, minlength=branch)
    denom = cnt * sxx - sx * sx
    safe = denom > 1e-30
    slope = np.where(safe, (cnt * sxy - sx * sy) / np.where(safe, denom, 1.0),
                     0.0)
    intercept = np.where(cnt > 0, (sy - slope * sx) / np.maximum(cnt, 1.0),
                         0.0)
    if (cnt == 0).any():
        populated = np.flatnonzero(cnt > 0)
        nearest = populated[np.clip(np.searchsorted(populated,
                                                    np.arange(branch)),
                                    0, populated.size - 1)]
        slope = np.where(cnt > 0, slope, slope[nearest])
        intercept = np.where(cnt > 0, intercept, intercept[nearest])
        x0 = np.where(cnt > 0, x0, x0[nearest])
    pred = slope[leaf] * (kf - x0[leaf]) + intercept[leaf]
    pred = np.clip(np.floor(pred), 0, n - 1).astype(np.int64)
    err = np.abs(pred - np.arange(n, dtype=np.int64))
    leaf_eps = np.zeros(branch, np.int64)
    starts = np.flatnonzero(np.diff(leaf, prepend=-1))
    leaf_eps[leaf[starts]] = np.maximum.reduceat(err, starts)
    return RMI(root_slope, root_intercept, int(branch),
               np.maximum(leaf_eps, 1), int(n))


def build_rmis(keys: np.ndarray, branches: Sequence[int],
               workers: int = 6) -> Dict[int, RMI]:
    kf = np.asarray(keys).astype(np.float64)
    root = _root(kf)
    with concurrent.futures.ThreadPoolExecutor(workers) as pool:
        built = list(pool.map(lambda b: _build(kf, root, int(b)), branches))
    return {int(b): r for b, r in zip(branches, built)}


def quantize_eps(eps: np.ndarray) -> np.ndarray:
    """Leaf errors rounded up to powers of two (section V-C's windows)."""
    eps = np.maximum(np.asarray(eps, np.int64), 1)
    return (2 ** np.ceil(np.log2(eps))).astype(np.int64)
