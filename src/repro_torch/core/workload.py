"""Workload — the query-side noun of the CostSession API.

A :class:`Workload` owns everything CAM needs to know about the queries and
nothing about any particular index: the query keys, their *true positions*
(ranks in the sorted key file — located once via ``searchsorted`` and cached,
so every (knob, budget) candidate reuses them), and the query shape
(point / range / sorted probe stream / mixed).

``sample()`` is the single implementation of CAM-x workload sampling that
previously existed as three divergent copies (``cam.sample_workload`` plus
inline variants in ``cam.estimate_range_io`` and ``rmi_tuner``).  Sampling
keeps positional order (required by the sorted closed form) and remembers the
pre-sample query count so compulsory-miss scaling stays exact.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from repro_torch import obs

__all__ = ["Workload", "locate", "subsample_indices"]

POINT = "point"
RANGE = "range"
SORTED = "sorted"
MIXED = "mixed"
INSERT = "insert"
UPDATE = "update"
DELETE = "delete"

#: Mutating kinds — point-shaped (one target rank per event): ``positions``
#: carry the located rank of the written key, ``query_keys`` the raw key.
WRITE_KINDS = (INSERT, UPDATE, DELETE)

_KINDS = (POINT, RANGE, SORTED, MIXED) + WRITE_KINDS


def locate(keys: np.ndarray, query_keys: np.ndarray) -> np.ndarray:
    """True ranks of ``query_keys`` in the sorted key file (LocateQueries).

    Computed ONCE per (dataset, workload) pair; every estimation call reuses
    the cached result — this is where CAM's tuning-loop speedup starts.

    The ranks are ``np.searchsorted(keys, query_keys, side="left")``
    clamped to ``n - 1``.  Where the query keys' dtype differs from the
    keys', ``searchsorted`` would copy the whole key file into the common
    dtype on every call; where :func:`_thresholds` can answer the same
    comparison in the keys' own dtype, the file is searched as it is.
    """
    keys = np.asarray(keys)
    query_keys = np.asarray(query_keys)
    n = keys.shape[0]
    with obs.span("cam.locate"):
        common = np.promote_types(keys.dtype, query_keys.dtype)
        if common == keys.dtype:
            pos = np.searchsorted(keys, query_keys, side="left")
        elif (mapped := _thresholds(keys, query_keys, common)) is not None:
            thresholds, past = mapped
            obs.count("locate.mapped_queries", query_keys.size)
            pos = np.where(past, n,
                           np.searchsorted(keys, thresholds, side="left"))
        else:
            # searchsorted copies the key file, and the queries unless they
            # already have the common dtype, before it searches
            obs.count("locate.cast_bytes", common.itemsize * (
                keys.size
                + (query_keys.size if query_keys.dtype != common else 0)))
            pos = np.searchsorted(keys, query_keys, side="left")
        return np.minimum(pos, n - 1).astype(np.int64)


def _thresholds(keys: np.ndarray, query_keys: np.ndarray, common: np.dtype):
    """Each query as the least key-dtype value that compares >= it.

    ``searchsorted`` compares ``keys`` and ``query_keys`` in ``common``, the
    float dtype both promote to.  For integer keys whose every value
    ``common`` holds exactly (its mantissa spans the file's first and last
    keys, so also every key between them), key ``k`` sorts below query
    ``x`` exactly when ``k < ceil(x)``.  So the rank of ``x`` is the rank
    of ``ceil(x)`` clipped to ``[keys[0], keys[-1]]``, except past the
    last key, and for NaN, which sorts last: there it is ``n``.  Returns
    ``(thresholds, past)`` in O(queries), or None where that does not hold.
    """
    if keys.dtype.kind not in "iu" or common.kind != "f" or not keys.size:
        return None
    exact = 1 << (np.finfo(common).nmant + 1)
    if int(keys[0]) < -exact or int(keys[-1]) > exact:
        return None
    x = query_keys.astype(common, copy=False)
    first, last = keys[[0, -1]].astype(common)
    past = ~(x <= last)
    t = np.ceil(np.maximum(np.where(past, last, x), first))
    return t.astype(keys.dtype), past


def subsample_indices(n: int, rate: float, seed: int = 0) -> np.ndarray:
    """Order-preserving CAM-x sample indices (sorted choice w/o replacement)."""
    rng = np.random.default_rng(seed)
    k = max(1, int(round(n * rate)))
    return np.sort(rng.choice(n, size=k, replace=False))


@dataclasses.dataclass(frozen=True)
class Workload:
    """Index-agnostic query description.

    Fields
    ------
    kind:          "point" | "range" | "sorted" | "mixed".
    positions:     point → true ranks; range → lower-bound ranks;
                   sorted → per-probe window-lo positions.
    hi_positions:  range → upper-bound ranks; sorted → window-hi positions.
    query_keys:    original query keys (needed by routing indexes, e.g. RMI);
                   range → the lower endpoints' keys.
    hi_query_keys: range → the upper endpoints' keys (an RMI routes each
                   endpoint to its own leaf).
    n:             size of the indexed key file (defines the page count).
    parts:         sub-workloads of a mixed workload.
    base_queries:  pre-sampling |Q| (compulsory-miss scaling of CAM-x).
    """

    kind: str
    positions: Optional[np.ndarray] = None
    hi_positions: Optional[np.ndarray] = None
    query_keys: Optional[np.ndarray] = None
    n: Optional[int] = None
    parts: Tuple["Workload", ...] = ()
    base_queries: Optional[int] = None
    hi_query_keys: Optional[np.ndarray] = None

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"unknown workload kind {self.kind!r}; "
                             f"expected one of {_KINDS}")

    # ------------------------------------------------------------------ build
    @classmethod
    def point(cls, positions: np.ndarray, *, n: Optional[int] = None,
              query_keys: Optional[np.ndarray] = None) -> "Workload":
        """Point lookups from pre-located true ranks."""
        return cls(POINT, positions=np.asarray(positions, np.int64),
                   query_keys=None if query_keys is None else np.asarray(query_keys),
                   n=n)

    @classmethod
    def from_keys(cls, keys: np.ndarray, query_keys: np.ndarray) -> "Workload":
        """Point lookups from raw query keys — locates once and caches."""
        keys = np.asarray(keys)
        return cls.point(locate(keys, query_keys), n=int(keys.shape[0]),
                         query_keys=np.asarray(query_keys))

    @classmethod
    def range_scan(cls, lo_positions: np.ndarray, hi_positions: np.ndarray,
                   *, n: Optional[int] = None,
                   query_keys: Optional[np.ndarray] = None,
                   hi_query_keys: Optional[np.ndarray] = None) -> "Workload":
        """Range scans [lo, hi] given rank bounds, and optionally the keys
        of both endpoints (``query_keys`` the lower, ``hi_query_keys`` the
        upper), which a routing index needs to find each end's leaf."""
        return cls(RANGE, positions=np.asarray(lo_positions, np.int64),
                   hi_positions=np.asarray(hi_positions, np.int64), n=n,
                   query_keys=None if query_keys is None
                   else np.asarray(query_keys),
                   hi_query_keys=None if hi_query_keys is None
                   else np.asarray(hi_query_keys))

    @classmethod
    def sorted_stream(cls, window_lo: np.ndarray, window_hi: np.ndarray,
                      *, n: Optional[int] = None) -> "Workload":
        """Sorted probe stream (joins): per-probe position windows, in order."""
        return cls(SORTED, positions=np.asarray(window_lo, np.int64),
                   hi_positions=np.asarray(window_hi, np.int64), n=n)

    @classmethod
    def insert(cls, positions: np.ndarray, *, n: Optional[int] = None,
               query_keys: Optional[np.ndarray] = None) -> "Workload":
        """Inserts at pre-located target ranks (where the new key lands)."""
        return cls(INSERT, positions=np.asarray(positions, np.int64),
                   query_keys=None if query_keys is None
                   else np.asarray(query_keys), n=n)

    @classmethod
    def update(cls, positions: np.ndarray, *, n: Optional[int] = None,
               query_keys: Optional[np.ndarray] = None) -> "Workload":
        """In-place value updates at pre-located true ranks."""
        return cls(UPDATE, positions=np.asarray(positions, np.int64),
                   query_keys=None if query_keys is None
                   else np.asarray(query_keys), n=n)

    @classmethod
    def delete(cls, positions: np.ndarray, *, n: Optional[int] = None,
               query_keys: Optional[np.ndarray] = None) -> "Workload":
        """Deletes (tombstone writes) at pre-located true ranks."""
        return cls(DELETE, positions=np.asarray(positions, np.int64),
                   query_keys=None if query_keys is None
                   else np.asarray(query_keys), n=n)

    @classmethod
    def mixed(cls, *parts: "Workload") -> "Workload":
        """Composite workload; page-reference histograms add across parts.

        Nested mixed parts are flattened (depth-first, order preserved), so
        trace-compiled batches — themselves mixed — compose without manual
        flattening: ``mixed(mixed(a, b), c).parts == (a, b, c)``.
        """
        if not parts:
            raise ValueError("mixed workload needs at least one part")
        flat: list = []
        for p in parts:
            flat.extend(p.parts if p.kind == MIXED else (p,))
        ns = {p.n for p in flat if p.n is not None}
        if len(ns) > 1:
            raise ValueError(f"mixed parts disagree on key-file size: {ns}")
        return cls(MIXED, parts=tuple(flat), n=ns.pop() if ns else None)

    @classmethod
    def concat(cls, *workloads: "Workload") -> "Workload":
        """Incremental construction: append workloads into one composite.

        Mixed inputs are flattened, then same-kind runs concatenate into a
        single part per kind (encounter order; array concatenation preserves
        each input's internal probe order, which the sorted closed form
        needs).  Returns the single merged part when only one kind appears —
        so a stream of trace-batch workloads folds into a compact profile
        input instead of an ever-growing parts tuple.
        """
        flat: list = []
        for w in workloads:
            flat.extend(w.parts if w.kind == MIXED else (w,))
        if not flat:
            raise ValueError("concat needs at least one workload")
        by_kind: dict = {}
        for p in flat:
            by_kind.setdefault(p.kind, []).append(p)

        def _cat(arrays):
            got = [a for a in arrays if a is not None]
            if not got:
                return None
            if len(got) != len(arrays):      # keys known only for some parts
                return None
            return np.concatenate(got)

        merged = []
        for kind, group in by_kind.items():
            if len(group) == 1:
                merged.append(group[0])
                continue
            ns = {p.n for p in group if p.n is not None}
            if len(ns) > 1:
                raise ValueError(f"concat parts disagree on key-file size: {ns}")
            base = sum(p.base_queries if p.base_queries is not None
                       else p.n_queries for p in group)
            merged.append(cls(
                kind,
                positions=_cat([p.positions for p in group]),
                hi_positions=_cat([p.hi_positions for p in group]),
                query_keys=_cat([p.query_keys for p in group]),
                n=ns.pop() if ns else None,
                base_queries=base,
                hi_query_keys=_cat([p.hi_query_keys for p in group]),
            ))
        return merged[0] if len(merged) == 1 else cls.mixed(*merged)

    # ---------------------------------------------------------------- split
    def split_at(self, cuts) -> Tuple["Workload", ...]:
        """Split into ``len(cuts) + 1`` segment workloads at rank boundaries.

        ``cuts`` are strictly increasing global ranks in ``(0, n)``; segment
        ``s`` owns ranks ``[cuts[s-1], cuts[s])`` (with the implicit edges 0
        and n).  Every point query lands in exactly ONE segment; range and
        sorted windows crossing a cut are split into per-segment pieces
        (clipped to the segment, emitted in original probe order — the
        sorted closed forms need it) via the same repeat + prefix-scan
        offset idiom as ``join.hybrid.partition_probes``.  Segments stay in
        GLOBAL coordinates (same ``n``), so ``Workload.concat`` of the
        pieces reproduces the original exactly when no window crosses a cut
        and preserves per-kind position multisets and total covered rank
        mass in general.  This is the shared routing primitive of
        ``ShardingSession`` (key-space shard boundaries) and any consumer
        that previously masked key ranges ad hoc.
        """
        cuts = np.asarray(cuts, np.int64)
        if cuts.ndim != 1:
            raise ValueError("cuts must be a 1-D array of ranks")
        if cuts.size == 0:
            return (self,)
        if np.any(np.diff(cuts) <= 0) or cuts[0] <= 0 or (
                self.n is not None and cuts[-1] >= self.n):
            raise ValueError(
                "cuts must be strictly increasing ranks inside (0, n); got "
                f"{cuts.tolist()} for n={self.n}")
        n_segs = int(cuts.size) + 1
        if self.kind == MIXED:
            per_part = [p.split_at(cuts) for p in self.parts]
            segs = []
            for s in range(n_segs):
                live = [pp[s] for pp in per_part if pp[s].n_queries > 0]
                if not live:
                    segs.append(Workload.point(np.zeros(0, np.int64),
                                               n=self.n))
                elif len(live) == 1:
                    segs.append(live[0])
                else:
                    segs.append(Workload.mixed(*live))
            return tuple(segs)
        if self.positions is None or self.n_queries == 0:
            return tuple(dataclasses.replace(self) for _ in range(n_segs))
        if self.kind in (POINT,) + WRITE_KINDS:
            # Writes are point-shaped: each event targets exactly one rank,
            # so segment routing is the same searchsorted bucket — the kind
            # tag rides along losslessly (ShardingSession must not silently
            # downgrade mutating traffic to reads).
            seg_of = np.searchsorted(cuts, self.positions, side="right")
            out = []
            for s in range(n_segs):
                m = seg_of == s
                out.append(Workload(
                    self.kind, positions=self.positions[m],
                    query_keys=(None if self.query_keys is None
                                else self.query_keys[m]),
                    n=self.n))
            return tuple(out)
        # range / sorted: a window may span several segments.  Pieces are
        # generated probe-major (then segment-minor), so each segment's
        # subsequence keeps the original probe order.
        lo = np.asarray(self.positions, np.int64)
        hi = np.asarray(self.hi_positions, np.int64)
        first = np.searchsorted(cuts, lo, side="right")
        last = np.searchsorted(cuts, hi, side="right")
        counts = last - first + 1
        probe = np.repeat(np.arange(lo.shape[0]), counts)
        # within-probe piece index: arange minus each probe's start offset
        # (exclusive prefix sum of counts, repeated) — the two-pass idiom.
        offs = (np.arange(probe.shape[0])
                - np.repeat(np.cumsum(counts) - counts, counts))
        seg = first[probe] + offs
        top = (int(self.n) if self.n is not None
               else int(hi.max()) + 1)
        edges_lo = np.concatenate([np.zeros(1, np.int64), cuts])
        edges_hi = np.concatenate([cuts, np.asarray([top], np.int64)])
        plo = np.maximum(lo[probe], edges_lo[seg])
        phi = np.minimum(hi[probe], edges_hi[seg] - 1)
        out = []
        for s in range(n_segs):
            m = seg == s
            out.append(Workload(self.kind, positions=plo[m],
                                hi_positions=phi[m], n=self.n))
        return tuple(out)

    # ------------------------------------------------------------- properties
    @property
    def n_queries(self) -> int:
        if self.kind == MIXED:
            return sum(p.n_queries for p in self.parts)
        return 0 if self.positions is None else int(self.positions.shape[0])

    @property
    def scale(self) -> float:
        """Full-workload / sample request-volume ratio (compulsory branch)."""
        base = self.base_queries if self.base_queries is not None else self.n_queries
        return max(1.0, base / max(self.n_queries, 1))

    # --------------------------------------------------------------- sampling
    def sample(self, rate: float, seed: int = 0) -> "Workload":
        """CAM-x: estimate from an x% sample (order preserved)."""
        if rate >= 1.0:
            return self
        if self.kind == MIXED:
            return dataclasses.replace(
                self, parts=tuple(p.sample(rate, seed) for p in self.parts))
        idx = subsample_indices(self.n_queries, rate, seed)
        take = lambda a: None if a is None else a[idx]  # noqa: E731
        return dataclasses.replace(
            self,
            positions=take(self.positions),
            hi_positions=take(self.hi_positions),
            query_keys=take(self.query_keys),
            hi_query_keys=take(self.hi_query_keys),
            base_queries=self.base_queries if self.base_queries is not None
            else self.n_queries,
        )
