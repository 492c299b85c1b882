"""ShardedSystem — a fleet of CAM nodes over one key-space partition.

A sharded deployment splits the sorted key file at rank boundaries: shard
``j`` owns the contiguous global ranks ``[cut[j-1], cut[j])`` (implicit
edges 0 and n) and serves them from its own node — same page geometry and
cache policy everywhere (one :class:`~repro_torch.core.session.System`
template), but each node runs its own learned index over its local key file
and its own buffer pool, carved out of ONE fleet-level memory budget by a
fraction simplex (the :class:`~repro_torch.join.tree.JoinTreeSession`
budget-split idea lifted from join-tree levels to shard nodes).

Page ownership follows the index-data separation layout: the global data
file is paged once (``page = rank // c_ipp``), and shard ``j`` owns every
page any of its ranks lives on — ``[lo_rank // c_ipp, (hi_rank-1) // c_ipp]``
inclusive.  A cut that is NOT page-aligned therefore REPLICATES its
boundary page on both neighbors (each holds the half it owns plus the
page's other residents), which is the ``boundary-page double-count`` the
routing invariants account for: per-shard logical page references sum to
the unsharded count plus one reference per mid-page boundary crossing.
Shard-local coordinates subtract ``page_lo * c_ipp``, so a local rank's
page is exactly its global page minus ``page_lo`` — local profiles are
global profiles translated, nothing re-derived.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.session import System

__all__ = ["Shard", "ShardedSystem", "even_boundaries"]


@dataclasses.dataclass(frozen=True)
class Shard:
    """One node's slice of the key space.

    ``[lo_rank, hi_rank)`` are the global ranks owned; ``[page_lo,
    page_hi]`` (inclusive) the global data pages served, and ``n_local``
    the local key-file size in shard coordinates (rank - page_lo * c_ipp)
    — sized from the page floor so local page ids are dense from 0.
    """

    lo_rank: int
    hi_rank: int
    page_lo: int
    page_hi: int
    n_local: int

    @property
    def n_ranks(self) -> int:
        return self.hi_rank - self.lo_rank

    @property
    def num_pages(self) -> int:
        return self.page_hi - self.page_lo + 1

    def localize(self, positions: np.ndarray, c_ipp: int) -> np.ndarray:
        """Global ranks -> shard-local ranks (page-floor translation)."""
        return np.asarray(positions, np.int64) - self.page_lo * c_ipp


def even_boundaries(n: int, n_shards: int) -> Tuple[int, ...]:
    """The even key-split baseline: cuts at j * n / S."""
    if n_shards < 1:
        raise ValueError("n_shards must be >= 1")
    return tuple(int(j * n // n_shards) for j in range(1, n_shards))


@dataclasses.dataclass(frozen=True)
class ShardedSystem:
    """N nodes sharing geometry/policy, split at ``boundaries``.

    ``node`` is the per-node System template (geometry, cache policy,
    device model); ``fleet_budget_bytes`` the TOTAL memory across nodes —
    the pool the per-shard budget simplex splits (defaults to the
    template's budget, i.e. "shard an existing node's budget").  With no
    boundaries this is a 1-shard fleet, golden-equivalent to the plain
    ``System``/``CostSession`` path.
    """

    node: System
    n: int
    boundaries: Tuple[int, ...] = ()
    fleet_budget_bytes: Optional[float] = None

    def __post_init__(self):
        cuts = tuple(int(c) for c in self.boundaries)
        object.__setattr__(self, "boundaries", cuts)
        if any(b <= a for a, b in zip((0,) + cuts, cuts + (self.n,))):
            raise ValueError(
                f"boundaries must be strictly increasing ranks inside "
                f"(0, {self.n}); got {list(cuts)}")
        if self.fleet_budget_bytes is None:
            object.__setattr__(self, "fleet_budget_bytes",
                               float(self.node.memory_budget_bytes))

    @property
    def n_shards(self) -> int:
        return len(self.boundaries) + 1

    @property
    def shards(self) -> Tuple[Shard, ...]:
        c_ipp = self.node.geom.c_ipp
        edges = (0,) + self.boundaries + (self.n,)
        out = []
        for lo, hi in zip(edges[:-1], edges[1:]):
            page_lo = lo // c_ipp
            page_hi = (hi - 1) // c_ipp
            out.append(Shard(lo, hi, page_lo, page_hi,
                             n_local=hi - page_lo * c_ipp))
        return tuple(out)

    @property
    def boundary_pages(self) -> Tuple[int, ...]:
        """Global page of each cut (the page a mid-page cut replicates)."""
        return tuple(c // self.node.geom.c_ipp for c in self.boundaries)

    @property
    def replicated_cuts(self) -> Tuple[int, ...]:
        """Cuts that are NOT page-aligned: their boundary page lives on
        both neighbors, and every window crossing them re-references it."""
        c_ipp = self.node.geom.c_ipp
        return tuple(c for c in self.boundaries if c % c_ipp != 0)

    def system_for(self, budget_bytes: float) -> System:
        """A node System owning ``budget_bytes`` of the fleet pool."""
        return dataclasses.replace(self.node,
                                   memory_budget_bytes=float(budget_bytes))

    def with_boundaries(self, boundaries: Sequence[int]) -> "ShardedSystem":
        return dataclasses.replace(self, boundaries=tuple(boundaries))
