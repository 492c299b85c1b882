"""Incremental workload sketches — sliding-window profiles without replay.

The serving loop must answer "what would each candidate configuration cost
on the CURRENT workload?" continuously, but a ``grid_profiles`` pass over
the whole trace is O(trace) and grows without bound.  The observation that
makes sketching exact rather than approximate: everything a
:class:`~repro_torch.core.session.GridProfiles` row holds is a SUM over
queries — Eq. 12/13 expected-reference histograms, request mass R, DAC
access mass, sorted-window coverage — so per-batch partial sums are a
lossless representation, and merging them is pure array addition.

:class:`WindowSketch` therefore keeps a ring buffer of per-batch
:class:`SketchChunk`s (``deque(maxlen=W)``): ``update(batch_workload)``
profiles ONE batch (O(batch x K), the only model call), appending evicts
the expired chunk, and ``to_profiles()`` re-merges the ≤ W live chunks —
O(W x K x P), independent of how much trace has ever flowed through.
Eviction is subtraction-free by construction: expired events were only ever
inside their own chunk, so dropping the chunk drops them exactly (no
decremental histogram surgery, no cancellation error).

The merge is a monoid (:class:`_Accum`): commutative array sums plus one
genuinely sequential statistic — the cross-chunk junction term of the
pressure-pinned sorted-scan correction.  A probe window whose lo page
equals the previous window's hi page is a guaranteed hit under any policy
(see ``page_ref.sorted_workload_stats``); when the two windows fall in
different chunks, neither chunk sees the junction.  Each accumulation
therefore carries its first-lo/last-hi boundary pages and the merge adds
``[right.first_lo == left.last_hi]`` — associative by construction, which
``tests/test_torch_serving.py`` holds against the reference.

Drift detection rides along: each chunk also carries candidate-independent
page-popularity, range-width, and op-mix histograms; :func:`tv_distance`
between normalized window summaries is what :class:`ServingSession`
thresholds.

Where the sums live: the per-page arrays of a chunk (``counts``,
``sorted_coverage``, ``write_counts``) are float64 tensors on the session's
torch device, so a sketch on the card never copies a (K, P) profile to the
host.  Elementwise float64 additions in the same left-to-right order give
the same sums on any device; the per-candidate scalars and the drift
summaries are small and stay numpy.
"""
from __future__ import annotations

import collections
import dataclasses
from functools import reduce
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.session import (CostSession, GridCandidate,
                                      GridProfiles, SortedScanPart,
                                      WriteStreamPart)
from repro_torch.core.workload import (DELETE, INSERT, MIXED, POINT, RANGE,
                                       SORTED, UPDATE, Workload)

__all__ = ["SketchChunk", "WindowSketch", "tv_distance",
           "shard_page_masses", "WIDTH_BINS", "DEFAULT_PAGE_BINS"]

WIDTH_BINS = 24           # log2 range/sorted window-width histogram
DEFAULT_PAGE_BINS = 32    # coarse page-popularity histogram

_OP_INDEX = {POINT: 0, RANGE: 1, SORTED: 2, INSERT: 3, UPDATE: 4, DELETE: 5}
_N_OPS = len(_OP_INDEX)


# ---------------------------------------------------------------------------
# Chunks and their merge monoid
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SketchChunk:
    """Lossless profile summary of ONE ingested batch.

    Per-candidate arrays are float64 partial sums of the batch's
    ``GridProfiles`` row (``dac_mass`` is ``E[DAC] * n_queries``, so it adds
    across batches); the sorted-stream state is shared across candidates
    (windows are position-defined, so only the Thm III.1 capacity premise
    ``sorted_min_caps`` varies by knob).  ``first_lo_page``/``last_hi_page``
    are the junction-boundary metadata described in the module docstring.
    """

    n_queries: int
    counts: torch.Tensor                    # (K, P) float64, on device
    totals: np.ndarray                      # (K,)
    dac_mass: np.ndarray                    # (K,)
    sorted_refs: float = 0.0
    sorted_pinned: float = 0.0
    sorted_coverage: Optional[torch.Tensor] = None  # (P,) float64
    sorted_min_caps: Optional[np.ndarray] = None    # (K,) int64
    write_counts: Optional[torch.Tensor] = None     # (K, P) float64
    write_refs: Optional[np.ndarray] = None        # (K,) float64
    first_lo_page: Optional[int] = None
    last_hi_page: Optional[int] = None
    page_pop: Optional[np.ndarray] = None   # (page_bins,) drift summary
    width_hist: Optional[np.ndarray] = None  # (WIDTH_BINS,)
    op_mix: Optional[np.ndarray] = None     # (_N_OPS,)


@dataclasses.dataclass
class _Accum:
    """The merge monoid over chunks: array sums + the junction statistic."""

    n_queries: int
    counts: torch.Tensor
    totals: np.ndarray
    dac_mass: np.ndarray
    sorted_refs: float
    sorted_pinned: float
    sorted_coverage: Optional[torch.Tensor]
    sorted_min_caps: Optional[np.ndarray]
    first_lo_page: Optional[int]
    last_hi_page: Optional[int]
    write_counts: Optional[torch.Tensor] = None
    write_refs: Optional[np.ndarray] = None

    @classmethod
    def lift(cls, c: SketchChunk) -> "_Accum":
        return cls(c.n_queries, c.counts, c.totals, c.dac_mass,
                   c.sorted_refs, c.sorted_pinned, c.sorted_coverage,
                   c.sorted_min_caps, c.first_lo_page, c.last_hi_page,
                   c.write_counts, c.write_refs)


def _opt_add(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return a + b


def _opt_max(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return np.maximum(a, b)


def merge_accums(left: _Accum, right: _Accum) -> _Accum:
    """Associative merge of two window accumulations (left precedes right).

    Everything adds except the capacity premise (elementwise max) and the
    boundary metadata: the junction term bridges left's last sorted window
    to right's first, and the merged accumulation keeps left's first /
    right's last boundary — exactly the fold a flat concatenation would
    produce, which is what makes the merge associative.
    """
    junction = 0.0
    if left.last_hi_page is not None and right.first_lo_page is not None:
        junction = 1.0 if right.first_lo_page == left.last_hi_page else 0.0
    return _Accum(
        n_queries=left.n_queries + right.n_queries,
        counts=left.counts + right.counts,
        totals=left.totals + right.totals,
        dac_mass=left.dac_mass + right.dac_mass,
        sorted_refs=left.sorted_refs + right.sorted_refs,
        sorted_pinned=left.sorted_pinned + right.sorted_pinned + junction,
        sorted_coverage=_opt_add(left.sorted_coverage, right.sorted_coverage),
        sorted_min_caps=_opt_max(left.sorted_min_caps, right.sorted_min_caps),
        first_lo_page=(left.first_lo_page if left.first_lo_page is not None
                       else right.first_lo_page),
        last_hi_page=(right.last_hi_page if right.last_hi_page is not None
                      else left.last_hi_page),
        write_counts=_opt_add(left.write_counts, right.write_counts),
        write_refs=_opt_add(left.write_refs, right.write_refs),
    )


# ---------------------------------------------------------------------------
# Drift summaries
# ---------------------------------------------------------------------------

def _iter_parts(workload: Workload):
    return workload.parts if workload.kind == MIXED else (workload,)


def _drift_summary(workload: Workload, num_pages: int, c_ipp: int,
                   page_bins: int):
    page_pop = np.zeros(page_bins, np.float64)
    width_hist = np.zeros(WIDTH_BINS, np.float64)
    op_mix = np.zeros(_N_OPS, np.float64)
    for p in _iter_parts(workload):
        if p.positions is None or p.n_queries == 0:
            continue
        pages = np.asarray(p.positions, np.int64) // c_ipp
        bins = np.minimum(pages * page_bins // max(num_pages, 1),
                          page_bins - 1)
        page_pop += np.bincount(bins, minlength=page_bins)
        op_mix[_OP_INDEX[p.kind]] += p.n_queries
        if p.hi_positions is not None:
            widths = (np.asarray(p.hi_positions, np.int64)
                      - np.asarray(p.positions, np.int64) + 1)
            wb = np.minimum(np.log2(np.maximum(widths, 1)).astype(np.int64),
                            WIDTH_BINS - 1)
            width_hist += np.bincount(wb, minlength=WIDTH_BINS)
    return page_pop, width_hist, op_mix


def _normalize(h: np.ndarray) -> np.ndarray:
    s = float(h.sum())
    return h / s if s > 0 else h


def shard_page_masses(summary: Dict[str, np.ndarray],
                      boundary_pages: Sequence[int],
                      num_pages: int) -> Tuple[float, ...]:
    """Per-shard query-mass fractions read off a sketch summary.

    The sharding layer's view of a serving sketch: the ``page_pop``
    histogram bins the GLOBAL page space, and shard boundaries are page
    positions (``ShardedSystem.boundary_pages``), so each bin's mass is
    attributed to the shard owning the bin's first page — no routing pass,
    no replay.  Resolution is ``page_bins``-coarse, which is exactly the
    hot-shard detector's need: it names the shard soaking up traffic, not
    exact counts.  Returns ``len(boundary_pages) + 1`` fractions summing
    to 1 (all zeros for an empty summary).
    """
    pop = np.asarray(summary["page_pop"], np.float64)
    page_bins = pop.shape[0]
    cuts = np.asarray(boundary_pages, np.int64)
    # first global page of each bin (inverse of the binning in
    # _drift_summary: page -> page * page_bins // num_pages)
    start = (np.arange(page_bins, dtype=np.int64) * max(num_pages, 1)
             + page_bins - 1) // page_bins
    shard = np.searchsorted(cuts, start, side="left")
    masses = np.zeros(cuts.shape[0] + 1, np.float64)
    np.add.at(masses, shard, pop)
    total = float(masses.sum())
    if total > 0:
        masses /= total
    return tuple(float(m) for m in masses)


def tv_distance(a: Dict[str, np.ndarray], b: Dict[str, np.ndarray]) -> float:
    """Worst-component total-variation distance between window summaries.

    Each summary component (page popularity, width histogram, op mix) is
    normalized and compared by TV = 0.5 Σ|p - q|; the max over components
    makes the detector sensitive to drift along ANY axis (a pure hot-set
    move shows up even when the op mix is unchanged).  Components empty on
    both sides contribute 0.
    """
    d = 0.0
    for k in a:
        pa, pb = _normalize(a[k]), _normalize(b[k])
        if pa.sum() == 0 and pb.sum() == 0:
            continue
        d = max(d, 0.5 * float(np.abs(pa - pb).sum()))
    return d


# ---------------------------------------------------------------------------
# The sketch
# ---------------------------------------------------------------------------

class WindowSketch:
    """Sliding-window workload sketch over a FIXED candidate grid.

    Bound to one :class:`CostSession` and one candidate list (the feasible
    knob points of the family being served).  ``update`` ingests one batch
    workload — the single ``grid_profiles`` call per batch is the only
    model work, O(batch x K) — and ``to_profiles`` re-merges the live
    window into a :class:`GridProfiles` for
    ``TuningSession.tune_from_profiles`` / ``CostSession.solve_profiles``.
    """

    def __init__(self, cost: CostSession,
                 candidates: Sequence[GridCandidate], *,
                 window_chunks: int = 8,
                 page_bins: int = DEFAULT_PAGE_BINS,
                 profile_executor: Optional[str] = None):
        if window_chunks < 1:
            raise ValueError("window_chunks must be >= 1")
        self.cost = cost
        self.system = cost.system
        self.profile_executor = profile_executor
        self.candidates = list(candidates)
        self.sizes = np.asarray([c.size_bytes for c in self.candidates],
                                np.float64)
        self.window_chunks = int(window_chunks)
        self.page_bins = int(page_bins)
        self.chunks: collections.deque = collections.deque(
            maxlen=self.window_chunks)
        self.knobs: Optional[Tuple[object, ...]] = None
        self.updates = 0
        self.events_ingested = 0

    # ---------------------------------------------------------------- update
    def update(self, workload: Workload) -> SketchChunk:
        """Ingest one batch: profile it, append its chunk, evict the oldest.

        O(batch x K) — profiles exactly this batch; nothing already
        ingested is touched, and eviction is the deque dropping the expired
        chunk (subtraction-free).
        """
        profs = self.cost.grid_profiles(self.candidates, workload,
                                        executor=self.profile_executor)
        if self.knobs is None:
            self.knobs = profs.knobs
        elif profs.knobs != self.knobs:
            raise ValueError(
                "candidate grid changed mid-sketch: batch profiled "
                f"{profs.knobs} but the window holds {self.knobs}")
        chunk = self._chunk_from(profs, workload)
        self.chunks.append(chunk)
        self.updates += 1
        self.events_ingested += chunk.n_queries
        return chunk

    def _chunk_from(self, profs: GridProfiles,
                    workload: Workload) -> SketchChunk:
        geom = self.system.geom
        num_pages = int(profs.counts.shape[1])
        page_pop, width_hist, op_mix = _drift_summary(
            workload, num_pages, geom.c_ipp, self.page_bins)
        chunk = SketchChunk(
            n_queries=int(profs.n_queries),
            counts=profs.counts.to(torch.float64),
            totals=np.asarray(profs.totals, np.float64),
            dac_mass=np.asarray(profs.dacs, np.float64) * profs.n_queries,
            page_pop=page_pop, width_hist=width_hist, op_mix=op_mix)
        if profs.wparts:
            # write streams are partial sums like everything else: keep the
            # per-candidate (K, P) expected-write histograms and masses
            zero_w = torch.zeros(num_pages, dtype=torch.float64,
                                 device=profs.counts.device)
            chunk.write_counts = torch.stack(
                [wp.counts.to(torch.float64) if wp is not None
                 else zero_w for wp in profs.wparts])
            chunk.write_refs = np.asarray(
                [wp.total_refs if wp is not None else 0.0
                 for wp in profs.wparts], np.float64)
        spart = next((sp for sp in profs.sparts if sp is not None), None)
        if spart is not None:
            chunk.sorted_refs = float(spart.total_refs)
            chunk.sorted_pinned = float(spart.pinned_retouches)
            chunk.sorted_coverage = spart.coverage.to(torch.float64)
            chunk.sorted_min_caps = np.asarray(
                [sp.min_capacity if sp is not None else 1
                 for sp in profs.sparts], np.int64)
            for p in _iter_parts(workload):
                if p.kind == SORTED and p.n_queries:
                    chunk.first_lo_page = int(p.positions[0]) // geom.c_ipp
                    chunk.last_hi_page = int(p.hi_positions[-1]) // geom.c_ipp
                    break
        return chunk

    # ----------------------------------------------------------------- views
    def __len__(self) -> int:
        return len(self.chunks)

    @property
    def full(self) -> bool:
        return len(self.chunks) == self.window_chunks

    def merged(self) -> _Accum:
        if not self.chunks:
            raise ValueError("empty sketch: ingest at least one batch first")
        return reduce(merge_accums, map(_Accum.lift, self.chunks))

    def to_profiles(self) -> GridProfiles:
        """The live window as a :class:`GridProfiles` — NO replay.

        Re-merges the ≤ W live chunks (array sums) and hands the result to
        ``GridProfiles.from_accumulated``; the output prices identically to
        a one-shot ``grid_profiles`` over the concatenation of the window's
        batches (property-tested), at O(W x K x P) cost independent of
        trace length.
        """
        acc = self.merged()
        sparts: List[Optional[SortedScanPart]]
        if acc.sorted_coverage is not None and acc.sorted_refs > 0:
            coverage = acc.sorted_coverage.to(torch.float32)
            distinct = float((acc.sorted_coverage > 0).sum())
            sparts = [SortedScanPart(
                total_refs=acc.sorted_refs, distinct_pages=distinct,
                min_capacity=int(acc.sorted_min_caps[i]), coverage=coverage,
                pinned_retouches=acc.sorted_pinned)
                for i in range(len(self.candidates))]
        else:
            sparts = [None] * len(self.candidates)
        wparts: Tuple[Optional[WriteStreamPart], ...] = ()
        if acc.write_counts is not None and float(acc.write_refs.sum()) > 0:
            wparts = tuple(
                WriteStreamPart(acc.write_counts[i].to(torch.float32),
                                float(acc.write_refs[i]))
                for i in range(len(self.candidates)))
        return GridProfiles.from_accumulated(
            self.system, self.knobs, acc.counts, acc.totals, acc.dac_mass,
            self.sizes, sparts, acc.n_queries, wparts=wparts)

    def summary(self) -> Dict[str, np.ndarray]:
        """Candidate-independent window summary for drift detection."""
        page_pop = np.zeros(self.page_bins, np.float64)
        width_hist = np.zeros(WIDTH_BINS, np.float64)
        op_mix = np.zeros(_N_OPS, np.float64)
        for c in self.chunks:
            page_pop += c.page_pop
            width_hist += c.width_hist
            op_mix += c.op_mix
        return {"page_pop": page_pop, "width": width_hist, "op_mix": op_mix}
