"""Two-layer RMI (Kraska et al., SIGMOD'18) with linear-spline leaf models.

Root: a linear CDF model routes a key to one of ``b`` leaves.  Leaves: per-leaf
linear least squares, fit with grouped closed-form regression (vectorized via
bincount — no per-leaf Python loop).  Unlike PGM there is no global error
bound: each leaf exposes its empirical max error ``eps_j`` (paper §V-C), and
the last-mile window for a query routed to leaf j is ±eps_j.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["RMIIndex", "build_rmi", "rmi_size_bytes"]

_BYTES_PER_LEAF = 24   # slope f8 + intercept f8 + eps i8
_BYTES_ROOT = 16


def rmi_size_bytes(branch: int) -> int:
    """Footprint of a branch-factor candidate WITHOUT building it.

    Root and per-leaf parameters are fixed-size, so RMI's size model is
    exact and analytic — which is what lets tuners drop budget-infeasible
    branches before paying an O(n) construction.
    """
    return _BYTES_ROOT + _BYTES_PER_LEAF * int(branch)


@dataclasses.dataclass(frozen=True)
class RMIIndex:
    root_slope: float
    root_intercept: float
    branch: int
    leaf_slope: np.ndarray      # (b,)
    leaf_intercept: np.ndarray  # (b,)
    leaf_x0: np.ndarray         # (b,) per-leaf centering key (first key)
    leaf_eps: np.ndarray        # (b,) int64 empirical max abs error
    n: int

    @property
    def size_bytes(self) -> int:
        return _BYTES_ROOT + _BYTES_PER_LEAF * self.branch

    def route(self, query_keys: np.ndarray) -> np.ndarray:
        q = np.asarray(query_keys).astype(np.float64)
        pos = self.root_slope * q + self.root_intercept
        leaf = np.floor(pos * self.branch / max(self.n, 1)).astype(np.int64)
        return np.clip(leaf, 0, self.branch - 1)

    def predict(self, query_keys: np.ndarray) -> np.ndarray:
        q = np.asarray(query_keys)
        leaf = self.route(q)
        dx = q.astype(np.float64) - self.leaf_x0[leaf]
        pred = self.leaf_slope[leaf] * dx + self.leaf_intercept[leaf]
        return np.clip(np.floor(pred), 0, self.n - 1).astype(np.int64)

    def window(self, query_keys: np.ndarray):
        """Per-query last-mile windows using the routed leaf's error bound."""
        q = np.asarray(query_keys)
        leaf = self.route(q)
        eps = self.leaf_eps[leaf]
        pred = self.predict(q)
        lo = np.clip(pred - eps, 0, self.n - 1)
        hi = np.clip(pred + eps, 0, self.n - 1)
        return lo, hi, eps

    def leaf_weights(self, query_keys: np.ndarray) -> np.ndarray:
        """Empirical routing distribution w_j of a workload (§V-C)."""
        leaf = self.route(query_keys)
        counts = np.bincount(leaf, minlength=self.branch).astype(np.float64)
        return counts / max(counts.sum(), 1.0)


def build_rmi(keys: np.ndarray, branch: int) -> RMIIndex:
    keys = np.asarray(keys)
    n = keys.shape[0]
    kf = keys.astype(np.float64)
    ranks = np.arange(n, dtype=np.float64)

    # Root linear CDF model (fit over all keys; closed form).
    kc = kf - kf.mean()
    denom = float((kc * kc).sum())
    root_slope = float((kc * ranks).sum() / denom) if denom > 0 else 0.0
    root_intercept = float(ranks.mean() - root_slope * kf.mean())

    leaf = np.clip(
        np.floor((root_slope * kf + root_intercept) * branch / n).astype(np.int64),
        0, branch - 1,
    )
    # Router is monotone (root_slope >= 0 on sorted keys), so each leaf owns a
    # contiguous key range; grouped least squares per leaf via bincount sums.
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
    slope = np.where(safe, (cnt * sxy - sx * sy) / np.where(safe, denom, 1.0), 0.0)
    intercept = np.where(cnt > 0, (sy - slope * sx) / np.maximum(cnt, 1.0), 0.0)
    # Empty leaves inherit the nearest populated leaf's prediction surface so
    # routed queries still produce sane windows.
    if (cnt == 0).any():
        populated = np.flatnonzero(cnt > 0)
        nearest = populated[
            np.clip(np.searchsorted(populated, np.arange(branch)), 0, populated.size - 1)
        ]
        slope = np.where(cnt > 0, slope, slope[nearest])
        intercept = np.where(cnt > 0, intercept, intercept[nearest])
        x0 = np.where(cnt > 0, x0, x0[nearest])

    idx = RMIIndex(
        root_slope=root_slope,
        root_intercept=root_intercept,
        branch=int(branch),
        leaf_slope=slope,
        leaf_intercept=intercept,
        leaf_x0=x0,
        leaf_eps=np.zeros(branch, np.int64),
        n=int(n),
    )
    # Empirical per-leaf max error over the indexed keys (vectorized).
    pred = idx.predict(keys)
    err = np.abs(pred - np.arange(n, dtype=np.int64))
    leaf_eps = np.zeros(branch, np.int64)
    np.maximum.at(leaf_eps, leaf, err)
    leaf_eps = np.maximum(leaf_eps, 1)  # window of at least one position
    return dataclasses.replace(idx, leaf_eps=leaf_eps)
