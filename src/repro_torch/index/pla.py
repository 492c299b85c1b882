"""Greedy error-bounded piecewise linear approximation (ε-PLA).

The feasible-slope-window algorithm (FITing-Tree / swing-filter style): a
segment anchored at its first point maintains the interval of slopes that keep
every covered point within ±eps; the segment closes when the interval empties.
Guarantees |f(k) - rank(k)| <= eps for every indexed key, with segment counts
within a small constant of the optimal (O'Rourke) PLA — sufficient for the
paper's size-model fitting (M_idx ∝ |K| / 2eps, §V-B).

The inner feasibility scan is vectorized with a doubling window so the Python
loop runs once per *segment*, not per key.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

__all__ = ["Segments", "build_pla", "predict_pla"]


@dataclasses.dataclass(frozen=True)
class Segments:
    """Arrays-of-struct PLA: predict(k) = slope*(k - first_key) + intercept."""

    first_key: np.ndarray   # (S,) uint64/float64 — segment anchor keys
    slope: np.ndarray       # (S,) float64
    intercept: np.ndarray   # (S,) float64 — global rank of the anchor
    eps: int

    def __len__(self) -> int:
        return int(self.first_key.shape[0])

    @property
    def bytes(self) -> int:
        # key (8B) + slope (4B) + intercept (4B), matching the PGM layout.
        return 16 * len(self)


def _first_violation(
    x: np.ndarray, j: int, hi_idx: int, eps: float
) -> Tuple[int, float]:
    """Extend the segment anchored at j as far as feasible within x[j:hi_idx].

    Returns (end_exclusive, slope): the segment covers [j, end_exclusive) and
    ``slope`` is a feasible midpoint slope for it.
    """
    n = x.shape[0]
    lo_run, hi_run = -np.inf, np.inf  # feasible slope interval so far
    slope = 0.0
    i = j + 1
    window = 64
    while i < n:
        stop = min(n, i + window)
        dx = (x[i:stop] - x[j]).astype(np.float64)
        dy = np.arange(i - j, stop - j, dtype=np.float64)
        lo_s = np.maximum.accumulate((dy - eps) / dx)
        hi_s = np.minimum.accumulate((dy + eps) / dx)
        lo_s = np.maximum(lo_s, lo_run)
        hi_s = np.minimum(hi_s, hi_run)
        bad = lo_s > hi_s
        if bad.any():
            v = int(np.argmax(bad))  # first violation inside this chunk
            if v > 0:
                lo_run, hi_run = float(lo_s[v - 1]), float(hi_s[v - 1])
            slope = 0.5 * (lo_run + hi_run) if np.isfinite(lo_run) else 0.0
            return i + v, slope
        lo_run, hi_run = float(lo_s[-1]), float(hi_s[-1])
        i = stop
        window = min(window * 2, 1 << 20)
    slope = 0.5 * (lo_run + hi_run) if np.isfinite(lo_run) else 0.0
    return n, slope


def build_pla(keys: np.ndarray, eps: int) -> Segments:
    """Segment sorted, distinct ``keys`` with error bound ``eps``."""
    keys = np.asarray(keys)
    n = keys.shape[0]
    if n == 0:
        raise ValueError("empty key set")
    firsts, slopes, intercepts = [], [], []
    j = 0
    while j < n:
        end, slope = _first_violation(keys, j, n, float(eps))
        firsts.append(keys[j])
        slopes.append(slope)
        intercepts.append(float(j))
        j = end
    return Segments(
        first_key=np.asarray(firsts, keys.dtype),
        slope=np.asarray(slopes, np.float64),
        intercept=np.asarray(intercepts, np.float64),
        eps=int(eps),
    )


def predict_pla(seg: Segments, query_keys: np.ndarray, n: int) -> np.ndarray:
    """Vectorized position prediction, clipped to [0, n-1]."""
    q = np.asarray(query_keys)
    idx = np.clip(np.searchsorted(seg.first_key, q, side="right") - 1, 0, None)
    dx = (q - seg.first_key[idx]).astype(np.float64)
    pred = seg.slope[idx] * dx + seg.intercept[idx]
    return np.clip(np.floor(pred), 0, n - 1).astype(np.int64)
