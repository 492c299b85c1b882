"""RadixSpline (Kipf et al., aiDM'20): single-pass error-bounded spline index.

Third index family under CAM (after PGM and RMI), demonstrating the paper's
index-agnosticism claim (§I property i): RadixSpline is error-bounded like
PGM — a greedy spline corridor guarantees |interp(k) - rank(k)| <= eps — so
the SAME CAM estimators apply with its fixed eps, no new modeling needed.

Build: one pass maintaining the feasible slope corridor from the last spline
knot; a radix table over key prefixes narrows the knot search at lookup.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["RadixSplineIndex", "build_radixspline"]


@dataclasses.dataclass(frozen=True)
class RadixSplineIndex:
    knots_key: np.ndarray       # (K,) spline knot keys
    knots_pos: np.ndarray       # (K,) knot ranks (float64)
    radix_table: np.ndarray     # (2^bits + 1,) knot index per key prefix
    radix_bits: int
    shift: int
    min_key: int
    eps: int
    n: int

    @property
    def size_bytes(self) -> int:
        return 16 * len(self.knots_key) + 4 * len(self.radix_table)

    def predict(self, query_keys: np.ndarray) -> np.ndarray:
        q = np.asarray(query_keys)
        # The radix table narrows the knot search on a real implementation
        # (its size is charged to the index footprint); the vectorized
        # reference path searches the knots directly — same result.
        idx = np.clip(np.searchsorted(self.knots_key, q, side="right") - 1,
                      0, len(self.knots_key) - 2)
        x0 = self.knots_key[idx].astype(np.float64)
        x1 = self.knots_key[idx + 1].astype(np.float64)
        y0 = self.knots_pos[idx]
        y1 = self.knots_pos[idx + 1]
        t = np.where(x1 > x0, (q.astype(np.float64) - x0) / (x1 - x0), 0.0)
        pred = y0 + np.clip(t, 0.0, 1.0) * (y1 - y0)
        return np.clip(np.floor(pred), 0, self.n - 1).astype(np.int64)

    def window(self, query_keys: np.ndarray):
        pred = self.predict(query_keys)
        lo = np.clip(pred - self.eps, 0, self.n - 1)
        hi = np.clip(pred + self.eps, 0, self.n - 1)
        return lo, hi


def build_radixspline(keys: np.ndarray, eps: int,
                      radix_bits: int = 16) -> RadixSplineIndex:
    """Greedy spline corridor (one pass) + radix table over key prefixes."""
    keys = np.asarray(keys)
    n = keys.shape[0]
    knots = [0]
    last = 0
    lo_s, hi_s = -np.inf, np.inf
    kf = keys.astype(np.float64)
    # GreedySplineCorridor: the line base->candidate must stay inside the
    # corridor accumulated from every interior point; tighten afterwards.
    for i in range(1, n):
        dx = kf[i] - kf[last]
        if dx <= 0:
            continue
        s = (i - last) / dx                     # slope of base -> candidate
        if s < lo_s or s > hi_s:
            knots.append(i - 1)                 # previous point becomes a knot
            last = i - 1
            dx = kf[i] - kf[last]
            lo_s, hi_s = -np.inf, np.inf
            if dx <= 0:
                continue
        lo_s = max(lo_s, (i - last - eps) / dx)
        hi_s = min(hi_s, (i - last + eps) / dx)
    if knots[-1] != n - 1:
        knots.append(n - 1)
    knot_idx = np.asarray(knots, np.int64)
    knots_key = keys[knot_idx]
    knots_pos = knot_idx.astype(np.float64)

    min_key = int(keys[0])
    key_range = int(keys[-1]) - min_key + 1
    shift = max(0, int(np.ceil(np.log2(max(key_range, 2)))) - radix_bits)
    prefixes = ((knots_key.astype(np.uint64) - np.uint64(min_key))
                >> np.uint64(shift)).astype(np.int64)
    table = np.zeros(2**radix_bits + 1, np.int64)
    np.maximum.at(table, prefixes + 1, np.arange(len(knots_key)))
    table = np.maximum.accumulate(table)
    return RadixSplineIndex(knots_key, knots_pos, table, radix_bits, shift,
                            min_key, int(eps), n)
