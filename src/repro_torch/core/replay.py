"""Ground-truth trace replay under real eviction policies (the paper's
Replay-x baseline, §VII-A).

Replay is inherently sequential (every LRU/LFU update depends on the previous
one), so it stays a host-side numpy/python simulator — its cost is exactly the
paper's motivation for CAM.  It is the *oracle* every estimator is validated
against, and also the engine behind the simulated buffered disk used by the
join executors.
"""
from __future__ import annotations

from collections import OrderedDict, deque
from typing import Iterable, List, Sequence, Tuple

import numpy as np

__all__ = [
    "Buffer",
    "LRUBuffer",
    "FIFOBuffer",
    "LFUBuffer",
    "CLOCKBuffer",
    "make_buffer",
    "replay_refs",
    "replay_windows",
    "replay_write_refs",
]


class Buffer:
    """Page buffer interface: ``access(page) -> hit?``.

    ``last_evicted`` holds the page evicted by the most recent ``access``
    (None when the access hit or fit without eviction) — the hook the
    write-replay oracle uses to count dirty-page writebacks.
    """

    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError("buffer capacity must be >= 1 page")
        self.capacity = int(capacity)
        self.last_evicted = None

    def access(self, page: int) -> bool:  # pragma: no cover - interface
        raise NotImplementedError

    def __contains__(self, page: int) -> bool:  # pragma: no cover - interface
        raise NotImplementedError


class LRUBuffer(Buffer):
    def __init__(self, capacity: int):
        super().__init__(capacity)
        self._od: "OrderedDict[int, None]" = OrderedDict()

    def access(self, page: int) -> bool:
        od = self._od
        self.last_evicted = None
        if page in od:
            od.move_to_end(page)
            return True
        if len(od) >= self.capacity:
            self.last_evicted, _ = od.popitem(last=False)
        od[page] = None
        return False

    def __contains__(self, page: int) -> bool:
        return page in self._od


class FIFOBuffer(Buffer):
    def __init__(self, capacity: int):
        super().__init__(capacity)
        self._queue: deque = deque()
        self._resident: set = set()

    def access(self, page: int) -> bool:
        self.last_evicted = None
        if page in self._resident:
            return True
        if len(self._resident) >= self.capacity:
            victim = self._queue.popleft()
            self._resident.discard(victim)
            self.last_evicted = victim
        self._queue.append(page)
        self._resident.add(page)
        return False

    def __contains__(self, page: int) -> bool:
        return page in self._resident


class LFUBuffer(Buffer):
    """O(1) LFU (freq buckets + min-freq pointer); LRU tie-break in-bucket."""

    def __init__(self, capacity: int):
        super().__init__(capacity)
        self._freq: dict = {}
        self._buckets: dict = {}  # freq -> OrderedDict of pages
        self._minfreq = 0

    def access(self, page: int) -> bool:
        freq = self._freq
        buckets = self._buckets
        self.last_evicted = None
        if page in freq:
            f = freq[page]
            del buckets[f][page]
            if not buckets[f]:
                del buckets[f]
                if self._minfreq == f:
                    self._minfreq = f + 1
            freq[page] = f + 1
            buckets.setdefault(f + 1, OrderedDict())[page] = None
            return True
        if len(freq) >= self.capacity:
            victims = buckets[self._minfreq]
            victim, _ = victims.popitem(last=False)
            if not victims:
                del buckets[self._minfreq]
            del freq[victim]
            self.last_evicted = victim
        freq[page] = 1
        buckets.setdefault(1, OrderedDict())[page] = None
        self._minfreq = 1
        return False

    def __contains__(self, page: int) -> bool:
        return page in self._freq


class CLOCKBuffer(Buffer):
    """Second-chance / CLOCK: circular scan over frames with reference bits.

    Beyond the paper's three policies — demonstrates policy pluggability.
    Under IRM its hit rate lies between FIFO and LRU (it approximates LRU
    with FIFO-cost bookkeeping), which CAM brackets with those estimators.
    """

    def __init__(self, capacity: int):
        super().__init__(capacity)
        self._frames: list = []
        self._refbit: dict = {}
        self._slot: dict = {}
        self._hand = 0

    def access(self, page: int) -> bool:
        self.last_evicted = None
        if page in self._refbit:
            self._refbit[page] = 1
            return True
        if len(self._frames) < self.capacity:
            self._slot[page] = len(self._frames)
            self._frames.append(page)
            self._refbit[page] = 1
            return False
        while True:                      # advance the hand, clearing ref bits
            victim = self._frames[self._hand]
            if self._refbit[victim]:
                self._refbit[victim] = 0
                self._hand = (self._hand + 1) % self.capacity
            else:
                del self._refbit[victim]
                del self._slot[victim]
                self.last_evicted = victim
                self._frames[self._hand] = page
                self._slot[page] = self._hand
                self._refbit[page] = 1
                self._hand = (self._hand + 1) % self.capacity
                return False

    def __contains__(self, page: int) -> bool:
        return page in self._refbit


_POLICY_CLASSES = {"lru": LRUBuffer, "fifo": FIFOBuffer, "lfu": LFUBuffer,
                   "clock": CLOCKBuffer}


def make_buffer(policy: str, capacity: int) -> Buffer:
    try:
        return _POLICY_CLASSES[policy](capacity)
    except KeyError:
        raise ValueError(f"unknown policy {policy!r}") from None


def replay_refs(
    refs: Sequence[int], capacity: int, policy: str = "lru"
) -> Tuple[int, int]:
    """Replay a flat page-reference trace. Returns (hits, misses)."""
    buf = make_buffer(policy, capacity)
    access = buf.access
    hits = 0
    for page in refs:
        if access(int(page)):
            hits += 1
    return hits, len(refs) - hits


def replay_write_refs(
    refs: Sequence[int],
    is_write: Sequence[bool],
    capacity: int,
    policy: str = "lru",
) -> Tuple[int, int]:
    """Replay a mixed read/write page trace. Returns (fetches, writebacks).

    Write refs pull the page through the same buffer (a write miss fetches
    the page first) and mark it dirty; evicting a dirty page costs one
    writeback.  Dirty pages still resident at end of trace are NOT flushed —
    the estimator models the amortized steady state, where writeback
    happens at eviction time and a page pinned in an infinite cache is
    never written back.
    """
    buf = make_buffer(policy, capacity)
    access = buf.access
    dirty: set = set()
    fetches = 0
    writebacks = 0
    for page, w in zip(refs, is_write):
        page = int(page)
        if not access(page):
            fetches += 1
        victim = buf.last_evicted
        if victim is not None and victim in dirty:
            dirty.discard(victim)
            writebacks += 1
        if w:
            dirty.add(page)
    return fetches, writebacks


def replay_windows(
    page_lo: np.ndarray,
    page_hi: np.ndarray,
    capacity: int,
    policy: str = "lru",
) -> np.ndarray:
    """Replay per-query page windows [lo_i, hi_i] (all-at-once fetching).

    Returns per-query physical miss counts — the ground-truth ``IO(Q)`` of
    Eq. 1.  Logical refs per query are ``hi - lo + 1``.
    """
    buf = make_buffer(policy, capacity)
    access = buf.access
    lo = np.asarray(page_lo, np.int64)
    hi = np.asarray(page_hi, np.int64)
    misses = np.zeros(lo.shape[0], np.int32)
    for i in range(lo.shape[0]):
        m = 0
        for page in range(lo[i], hi[i] + 1):
            if not access(page):
                m += 1
        misses[i] = m
    return misses
