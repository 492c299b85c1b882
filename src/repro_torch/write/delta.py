"""Delta-buffer staging: deferred writes and their merge bursts.

A :class:`DeltaBuffer` models the memory-resident staging area updatable
disk indexes put in front of the base structure (ALEX's delta nodes, the
LSM memtable, B^eps-tree node buffers): writes append to it instead of
dirtying base pages, so a staged write costs NO immediate I/O.  The two
costs it defers are exactly what the scheduler weighs:

* **capacity pressure** — the delta lives in the same memory budget as the
  buffer pool, so every staged entry shrinks the page cache
  (``stolen_pages``).  Reads keep probing the base; their miss rate is the
  CAM fixed point at the SHRUNKEN capacity — no new model, just Eq. 7/8 at
  ``C(d)``;
* **the merge burst** — flushing rewrites every base page the staged keys
  touch, in key order.  :func:`merge_burst_workload` compiles the staged
  ranks into a sorted-stream workload (coalesced page runs), so the burst
  prices through the SAME Theorem III.1 sorted-scan model every other
  sorted sweep in the repo uses.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List

import numpy as np

from repro_torch.core.workload import WRITE_KINDS, Workload

__all__ = ["DeltaBuffer", "merge_burst_workload"]


@dataclasses.dataclass
class DeltaBuffer:
    """Memory-resident write staging area (entry-counted, rank-tracked).

    Tracks how many mutations are pending and WHERE they land (base-file
    ranks), because both matter: the count fixes the stolen cache pages,
    the rank spread fixes the merge burst's page coverage.
    """

    capacity_entries: int
    entry_bytes: float = 16.0
    entries: int = 0
    staged_total: int = 0                  # lifetime staged events
    merges: int = 0                        # lifetime merges
    _positions: List[np.ndarray] = dataclasses.field(default_factory=list)

    def stage(self, workload: Workload) -> int:
        """Stage every mutating part of ``workload``; returns events staged.

        The buffer intentionally accepts overflow past ``capacity_entries``
        (``full`` turns True) — ENFORCING the bound is the scheduler's job,
        and merge-on-full baselines need to observe the full state rather
        than have it resolved under them.
        """
        staged = 0
        for part in (workload.parts if workload.kind == "mixed"
                     else (workload,)):
            if part.kind in WRITE_KINDS and part.n_queries:
                self._positions.append(
                    np.asarray(part.positions, np.int64).ravel())
                staged += part.n_queries
        self.entries += staged
        self.staged_total += staged
        return staged

    @property
    def bytes_used(self) -> float:
        return self.entries * self.entry_bytes

    @property
    def full(self) -> bool:
        return self.entries >= self.capacity_entries

    def stolen_pages(self, page_bytes: int) -> int:
        """Buffer-pool pages the staged entries displace."""
        return int(math.ceil(self.bytes_used / max(page_bytes, 1)))

    def positions(self) -> np.ndarray:
        """All staged ranks (unsorted, duplicates preserved)."""
        if not self._positions:
            return np.zeros(0, np.int64)
        return np.concatenate(self._positions)

    def clear(self) -> int:
        """Merge completed: empty the buffer; returns entries flushed."""
        flushed = self.entries
        self.entries = 0
        self._positions = []
        self.merges += 1 if flushed else 0
        return flushed


def merge_burst_workload(positions: np.ndarray, n: int,
                         c_ipp: int) -> Workload:
    """Compile staged ranks into the merge's sorted rewrite burst.

    The merge walks the staged keys in sorted order and rewrites each base
    page they touch; staged keys on the same or adjacent pages share one
    sequential run.  Coalescing sorted target pages wherever consecutive
    staged pages are within one page of each other yields one sorted-stream
    window per run — a monotone probe sequence, which is exactly the access
    pattern Theorem III.1's closed forms price (and what lets a big buffer
    make re-touched merge pages free).
    """
    pos = np.sort(np.asarray(positions, np.int64).ravel())
    if pos.shape[0] == 0:
        raise ValueError("empty delta: no merge burst to compile")
    pages = np.unique(pos // max(c_ipp, 1))
    # run breaks: next touched page more than one page away
    breaks = np.nonzero(np.diff(pages) > 1)[0]
    starts = np.concatenate([[0], breaks + 1])
    ends = np.concatenate([breaks, [pages.shape[0] - 1]])
    lo = np.minimum(pages[starts] * c_ipp, n - 1)
    hi = np.minimum(pages[ends] * c_ipp + (c_ipp - 1), n - 1)
    return Workload.sorted_stream(lo, np.maximum(hi, lo), n=n)
