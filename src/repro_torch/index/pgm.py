"""Disk-oriented PGM-index (Ferragina & Vinciguerra, VLDB'20).

Recursive ε-PLA: level 0 segments the data keys, level ℓ+1 segments the
first-keys of level ℓ, until one segment remains.  Index-data separation
(§II-B): the PGM levels live in memory; data pages live on "disk".  Only the
leaf-level prediction drives I/O — traversal is in-memory and O(log log n).

Lookup guarantee: |predict(k) - rank(k)| <= eps for every indexed key.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from repro_torch.index import pla

__all__ = ["PGMIndex", "build_pgm"]


@dataclasses.dataclass(frozen=True)
class PGMIndex:
    levels: List[pla.Segments]   # levels[0] = leaf level over the data keys
    eps: int
    n: int

    @property
    def size_bytes(self) -> int:
        return int(sum(level.bytes for level in self.levels))

    @property
    def num_segments(self) -> int:
        return len(self.levels[0])

    def predict(self, query_keys: np.ndarray) -> np.ndarray:
        """Leaf-level position prediction (vectorized, error within ±eps)."""
        return pla.predict_pla(self.levels[0], query_keys, self.n)

    def window(self, query_keys: np.ndarray):
        """Last-mile search windows [pred-eps, pred+eps], clipped."""
        pred = self.predict(query_keys)
        lo = np.clip(pred - self.eps, 0, self.n - 1)
        hi = np.clip(pred + self.eps, 0, self.n - 1)
        return lo, hi


def build_pgm(keys: np.ndarray, eps: int, eps_internal: int | None = None) -> PGMIndex:
    keys = np.asarray(keys)
    levels = [pla.build_pla(keys, eps)]
    eps_int = eps if eps_internal is None else eps_internal
    while len(levels[-1]) > 1:
        level_keys = levels[-1].first_key
        levels.append(pla.build_pla(level_keys, max(1, eps_int)))
        if len(levels[-1]) >= len(levels[-2]):  # degenerate (tiny inputs)
            break
    return PGMIndex(levels=levels, eps=int(eps), n=int(keys.shape[0]))
