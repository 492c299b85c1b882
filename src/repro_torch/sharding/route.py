"""Routing — send one global Workload through a shard fleet.

``route`` is ``Workload.split_at`` (the vectorized repeat + prefix-scan
partition kernel, same idiom as ``join.hybrid.partition_probes``) followed
by a coordinate translation into each shard's local rank space.  Every
point query lands on exactly one shard; range and sorted windows crossing
a boundary are clipped into per-shard pieces, and ``RouteStats`` carries
the exact accounting the invariants need:

* ``boundary_splits`` — how many extra probe pieces the cuts created
  (sum of routed query counts minus the original count);
* ``boundary_page_overlap`` — the double-count term: one extra logical
  page reference per window crossing a NON-page-aligned cut, because the
  cut's page is replicated on both neighbors and both clipped pieces
  touch it.  At eps=0 the per-shard page-reference totals sum to the
  unsharded total plus exactly this term.

Boundary candidates come from workload *query quantiles* — equal query
mass per shard — blended toward the even key split, so the search grid
spans "balance keys" to "balance traffic".
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core.workload import MIXED, Workload

from .system import ShardedSystem, even_boundaries

__all__ = ["RouteStats", "route", "quantile_boundaries",
           "boundary_candidates"]


@dataclasses.dataclass(frozen=True)
class RouteStats:
    """Bookkeeping from one routing pass (global counts, not per shard)."""

    boundary_splits: int
    boundary_page_overlap: int


def _localize(workload: Workload, offset: int, n_local: int) -> Workload:
    """Translate a global-coordinate segment into shard-local ranks."""
    if workload.kind == MIXED:
        return dataclasses.replace(
            workload, n=n_local,
            parts=tuple(_localize(p, offset, n_local) for p in workload.parts))
    shift = lambda a: None if a is None else a - offset  # noqa: E731
    return dataclasses.replace(
        workload, n=n_local,
        positions=shift(workload.positions),
        hi_positions=shift(workload.hi_positions))


def _overlap(workload: Workload, cuts: np.ndarray) -> int:
    """Windows crossing each replicated cut (lo < cut <= hi), summed."""
    if workload.kind == MIXED:
        return sum(_overlap(p, cuts) for p in workload.parts)
    if workload.hi_positions is None or workload.n_queries == 0 or not cuts.size:
        return 0
    lo = workload.positions[:, None]
    hi = workload.hi_positions[:, None]
    return int(np.sum((lo < cuts[None, :]) & (hi >= cuts[None, :])))


def route(workload: Workload, sharded: ShardedSystem,
          ) -> Tuple[Tuple[Workload, ...], RouteStats]:
    """Partition ``workload`` across the fleet; returns local sub-workloads.

    Sub-workload ``j`` is shard ``j``'s traffic in LOCAL coordinates
    (ranks relative to ``page_lo * c_ipp``, key-file size ``n_local``) —
    ready to profile against a shard-local index with no further
    translation.  With one shard this is the identity (offset 0, same n),
    which is what makes the 1-shard fleet golden-equivalent to the
    unsharded path.
    """
    if workload.n is not None and workload.n != sharded.n:
        raise ValueError(
            f"workload n={workload.n} != fleet n={sharded.n}")
    c_ipp = sharded.node.geom.c_ipp
    segments = workload.split_at(np.asarray(sharded.boundaries, np.int64)) \
        if sharded.boundaries else (workload,)
    shards = sharded.shards
    locals_ = tuple(
        _localize(seg, sh.page_lo * c_ipp, sh.n_local)
        for seg, sh in zip(segments, shards))
    splits = sum(s.n_queries for s in segments) - workload.n_queries
    overlap = _overlap(workload,
                       np.asarray(sharded.replicated_cuts, np.int64))
    return locals_, RouteStats(boundary_splits=int(splits),
                               boundary_page_overlap=overlap)


# --------------------------------------------------------------- candidates
def _mass_positions(workload: Workload) -> List[np.ndarray]:
    if workload.kind == MIXED:
        out: List[np.ndarray] = []
        for p in workload.parts:
            out.extend(_mass_positions(p))
        return out
    if workload.positions is None or workload.n_queries == 0:
        return []
    if workload.hi_positions is None:
        return [workload.positions]
    # a window contributes mass at both ends, so wide scans pull cuts too
    return [workload.positions, workload.hi_positions]


def _normalize(cuts: np.ndarray, n: int) -> Optional[Tuple[int, ...]]:
    """Clamp into (0, n) and force strict increase; None if impossible."""
    cuts = np.sort(np.asarray(cuts, np.int64))
    cuts = np.clip(cuts, 1, n - 1)
    for i in range(1, cuts.size):          # nudge duplicates forward
        if cuts[i] <= cuts[i - 1]:
            cuts[i] = cuts[i - 1] + 1
    if cuts.size and cuts[-1] >= n:
        return None
    return tuple(int(c) for c in cuts)


def quantile_boundaries(workload: Workload, n: int, n_shards: int,
                        ) -> Optional[Tuple[int, ...]]:
    """Cuts at query-mass quantiles: each shard gets ~equal traffic."""
    if n_shards < 2:
        return ()
    mass = _mass_positions(workload)
    if not mass:
        return _normalize(np.asarray(even_boundaries(n, n_shards)), n)
    pos = np.sort(np.concatenate(mass))
    qs = np.arange(1, n_shards) / n_shards
    cuts = np.quantile(pos, qs, method="nearest").astype(np.int64)
    return _normalize(cuts, n)


def boundary_candidates(workload: Workload, n: int, n_shards: int,
                        blends: Tuple[float, ...] = (0.5,),
                        ) -> Tuple[Tuple[int, ...], ...]:
    """The boundary search grid: even split, traffic quantiles, blends.

    Blend ``t`` interpolates cut-by-cut between the even key split
    (t=0) and the pure quantile split (t=1); duplicates after rounding
    and normalization are dropped, order preserved.
    """
    if n_shards < 2:
        return ((),)
    even = np.asarray(even_boundaries(n, n_shards), np.float64)
    quant = quantile_boundaries(workload, n, n_shards)
    cands: List[Tuple[int, ...]] = []
    seen = set()

    def _add(c: Optional[Tuple[int, ...]]):
        if c is not None and c not in seen:
            seen.add(c)
            cands.append(c)

    _add(_normalize(even, n))
    if quant is not None:
        qarr = np.asarray(quant, np.float64)
        for t in blends:
            _add(_normalize(np.round((1 - t) * even + t * qarr), n))
        _add(quant)
    return tuple(cands)
