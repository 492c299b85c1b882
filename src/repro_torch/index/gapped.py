"""Updatable leaf layouts: ALEX-style gapped arrays and B+-tree leaves.

Read-only learned indexes pack keys densely; updatable ones buy cheap
inserts with slack space, and CAM must price what that slack does to BOTH
I/O streams:

* the READ side — slack inflates the on-disk footprint (``slots > n``), so
  every probe window covers more pages (the ``to_slot_space`` remap);
* the WRITE side — an insert shifts elements until it finds a gap (gapped
  array) or amortizes node splits (B+-tree), dirtying more than one page
  (the ``*_write_amp`` closed forms).

:class:`GappedArray` is a small explicit-occupancy simulator, NOT a real
index: it exists so the analytic forms the adapters price with have a
replayable ground truth (property-tested invariants: inserts never shrink
the layout; ``merge`` restores the fill-factor bound).  The adapters in
``repro_torch.index.adapters`` use only the closed forms.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np

from repro_torch.core.workload import MIXED, Workload

__all__ = ["GappedArray", "gapped_slots", "btree_slots",
           "gapped_write_amp", "btree_write_amp", "to_slot_space"]


def gapped_slots(n: int, gap_density: float) -> int:
    """Slot count of a gapped layout holding ``n`` keys at the target
    density (``gap_density`` = fraction of slots left empty)."""
    if not 0.0 <= gap_density < 1.0:
        raise ValueError(f"gap_density must be in [0, 1), got {gap_density}")
    return max(int(math.ceil(n / max(1.0 - gap_density, 1e-9))), n + 1)


def btree_slots(n: int, fill_factor: float) -> int:
    """Slot count of B+-tree leaves holding ``n`` keys at ``fill_factor``."""
    if not 0.0 < fill_factor <= 1.0:
        raise ValueError(f"fill_factor must be in (0, 1], got {fill_factor}")
    return max(int(math.ceil(n / fill_factor)), n)


def gapped_write_amp(gap_density: float, c_ipp: int) -> float:
    """Expected pages dirtied per gapped-array insert.

    With gaps uniform at density ``g``, the shift to the nearest gap scans a
    geometric number of slots (mean ``1/g``), so an insert dirties the
    target page plus ``(1/g) / c_ipp`` shift-span pages in expectation.
    ``g -> 0`` diverges (a packed array shifts O(n)); clamp to one page of
    span so degenerate knobs stay finite.
    """
    span = 1.0 / max(gap_density, 1.0 / max(c_ipp, 1))
    return 1.0 + span / max(c_ipp, 1)


def btree_write_amp(fill_factor: float, c_ipp: int) -> float:
    """Expected pages dirtied per B+-tree insert.

    The leaf write is 1 page; a split (2 page writes + parent update ~ 3)
    amortizes over the ``(1 - f) * c_ipp`` free slots the split opened."""
    free = max((1.0 - fill_factor) * max(c_ipp, 1), 1.0)
    return 1.0 + 3.0 / free


def to_slot_space(workload: Workload, n: int, slots: int) -> Workload:
    """Remap a rank-space workload onto a slack layout's slot space.

    Ranks scale by ``slots / n`` (monotone, order-preserving — the sorted
    closed forms survive the remap), so probe windows cover the extra pages
    the slack costs.  Applied recursively to mixed parts.
    """
    if workload.kind == MIXED:
        return Workload(MIXED, parts=tuple(
            to_slot_space(p, n, slots) for p in workload.parts), n=slots)

    def remap(a: Optional[np.ndarray]) -> Optional[np.ndarray]:
        if a is None:
            return None
        scaled = (np.asarray(a, np.int64) * int(slots)) // max(int(n), 1)
        return np.minimum(scaled, int(slots) - 1)

    return dataclasses.replace(workload, positions=remap(workload.positions),
                               hi_positions=remap(workload.hi_positions),
                               n=slots)


class GappedArray:
    """Explicit-occupancy gapped-array simulator (the adapters' oracle).

    Tracks which slots hold keys.  ``insert`` places a key at its fractional
    target position, shifting to the nearest gap (ALEX's in-leaf shift);
    ``merge`` rebuilds the layout at the target gap density (the delta-merge
    / SMO the scheduler prices).  Page counts derive from the slot span, so
    the two scheduler-relevant invariants are directly observable:
    inserting can only grow the layout, merging restores the fill bound.
    """

    def __init__(self, n: int, gap_density: float):
        self.gap_density = float(gap_density)
        self.count = int(n)
        slots = gapped_slots(self.count, self.gap_density)
        self.occupied = np.zeros(slots, bool)
        if self.count:
            self.occupied[(np.arange(self.count, dtype=np.int64)
                           * slots) // self.count] = True

    @property
    def slots(self) -> int:
        return int(self.occupied.shape[0])

    def fill_factor(self) -> float:
        return self.count / max(self.slots, 1)

    def pages(self, c_ipp: int) -> int:
        return int(math.ceil(self.slots / max(c_ipp, 1)))

    def insert(self, frac: float) -> int:
        """Insert at fractional position ``frac``; returns slots dirtied
        (the shifted span plus the landing slot)."""
        if not 0.0 <= frac < 1.0:
            raise ValueError(f"frac must be in [0, 1), got {frac}")
        if self.occupied.all():
            # full leaf: expand with trailing gaps (the no-merge fallback a
            # real tree resolves with a split — layout only ever grows)
            grown = gapped_slots(self.count + 1, self.gap_density)
            pad = np.zeros(max(grown - self.slots, 1), bool)
            self.occupied = np.concatenate([self.occupied, pad])
        slot = min(int(frac * self.slots), self.slots - 1)
        free_right = np.nonzero(~self.occupied[slot:])[0]
        if free_right.size:
            gap = slot + int(free_right[0])
        else:
            gap = int(np.nonzero(~self.occupied[:slot])[0][-1])
        lo, hi = min(slot, gap), max(slot, gap)
        self.occupied[lo:hi + 1] = True
        self.count += 1
        return hi - lo + 1

    def merge(self) -> int:
        """Rebuild at the target gap density (delta merge / SMO); returns
        slots written (the whole new layout — a sorted-scan burst)."""
        slots = gapped_slots(self.count, self.gap_density)
        self.occupied = np.zeros(slots, bool)
        if self.count:
            self.occupied[(np.arange(self.count, dtype=np.int64)
                           * slots) // self.count] = True
        return slots
