"""CostSession — the index-agnostic estimation surface of CAM.

The paper's claim that CAM "is not tied to a particular learned index design"
is realized here as three nouns plus a session object:

* :class:`~repro_torch.core.workload.Workload` — queries, cached true positions,
  shapes (point / range / sorted / mixed), CAM-x sampling;
* :class:`IndexModel` — anything exposing ``size_bytes`` + knob metadata +
  a ``page_ref_profile(workload, geom)`` returning the Eq. 12/13/14
  histograms (adapters for PGM, RMI and RadixSpline live in
  ``repro_torch.index.adapters``);
* :class:`System` — page geometry, memory budget, cache policy, optional
  device-side cost model.

``CostSession.estimate`` reproduces Algorithm 1 for a single configuration;
``CostSession.estimate_grid`` evaluates an entire knob grid (eps grid x
per-candidate buffer capacities) in ONE batched pass over shared page-ref
state — K lockstep bisections instead of K Python loop iterations, which
is the tuning-loop speedup the paper's §V needs.

Every tensor a session makes lives on ``System.torch_device`` — the card by
default; ``torch_device="cpu"`` runs the plain torch path on the host.
Asking for CUDA where there is none raises: nothing falls back to the CPU.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import (Dict, NamedTuple, Optional, Protocol, Sequence, Tuple,
                    runtime_checkable)

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import obs
from repro_torch.core import cache_models, dac, page_ref
from repro_torch.core.cam import CamEstimate, CamGeometry, capacity_pages
from repro_torch.core.workload import (INSERT, MIXED, POINT, RANGE, SORTED,
                                 WRITE_KINDS, Workload)

__all__ = [
    "System",
    "SortedScanPart",
    "WriteStreamPart",
    "PageRefProfile",
    "IndexModel",
    "UniformEpsModel",
    "GridCandidate",
    "GridResult",
    "GridProfiles",
    "SkippedCandidate",
    "PlanCost",
    "CostSession",
    "UnsupportedWorkloadError",
    "uniform_eps_profile",
    "sorted_stream_profile",
    "DEFAULT_TORCH_DEVICE",
    "resolve_torch_device",
]

#: Where entry points run unless the caller asks otherwise: the card.
DEFAULT_TORCH_DEVICE = "cuda"


def resolve_torch_device(device) -> torch.device:
    """``device`` as a :class:`torch.device`, refusing CUDA without a card.

    The port never falls back to the CPU on its own: a CUDA request on a
    machine without one is an error the caller must answer by asking for
    ``"cpu"`` explicitly.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"torch device {str(device)!r} requested but CUDA is not "
            "available; pass torch_device='cpu' to run the plain torch path "
            "on the host")
    return dev


def _np64(x) -> np.ndarray:
    """A host float64 copy of a tensor (or array-like)."""
    return np.asarray(obs.to_host(x), np.float64)


class UnsupportedWorkloadError(ValueError):
    """A workload (or one of its parts) an estimation path cannot price.

    Carries the offending ``kind`` (and, for composite workloads, the
    ``part`` kind that triggered it) so callers — notably
    ``CostSession.estimate_grid``, which records per-candidate skip reasons —
    can report *what* was unsupported instead of a bare message.
    """

    def __init__(self, kind: str, part: Optional[str] = None,
                 detail: str = ""):
        self.kind = kind
        self.part = part
        msg = f"unsupported workload kind {kind!r}"
        if part is not None:
            msg += f" (offending part: {part!r})"
        if detail:
            msg += f": {detail}"
        super().__init__(msg)


# ---------------------------------------------------------------------------
# System: where the index runs
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class System:
    """Disk geometry + memory budget + cache policy (+ device model).

    ``device`` is the storage device's COST model
    (``repro_torch.core.device_models``); ``torch_device`` is where the
    estimator's tensors live — the card unless the caller asks for the CPU.
    """

    geom: CamGeometry = CamGeometry()
    memory_budget_bytes: float = 8 << 20
    policy: str = "lru"
    device: Optional[object] = None   # repro_torch.core.device_models instance
    torch_device: str = DEFAULT_TORCH_DEVICE

    def __post_init__(self):
        # Validate eagerly: the compulsory-miss branch never consults the
        # policy, so a typo could otherwise survive a whole tuning run.
        if self.policy not in cache_models.POLICIES:
            raise ValueError(f"unknown policy {self.policy!r}; expected one "
                             f"of {cache_models.POLICIES}")
        resolve_torch_device(self.torch_device)

    def capacity_for(self, index_bytes: float) -> int:
        """Buffer capacity left once the index is resident (Alg. 1 l. 15)."""
        return capacity_pages(self.memory_budget_bytes, index_bytes,
                              self.geom.page_bytes)

    def with_budget_fraction(self, fraction: float, *,
                             pool_bytes: Optional[float] = None,
                             resident_bytes: float = 0.0) -> "System":
        """A view of this System owning ``fraction`` of a shared buffer pool.

        ``pool_bytes`` is the pool being split (defaults to the full memory
        budget); ``resident_bytes`` is memory this view's consumer keeps
        resident on top of its slice (its index), added back so that
        ``view.capacity_for(resident_bytes)`` returns exactly the slice:
        ``floor(fraction * pool / page_bytes)`` pages.  Join trees use this
        to hand each level a System whose budget is its share of the ONE
        pool left after all inner indexes are resident — geometry, policy
        and device model stay shared.
        """
        if not 0.0 <= fraction <= 1.0:
            raise ValueError(f"budget fraction must be in [0, 1], "
                             f"got {fraction}")
        pool = self.memory_budget_bytes if pool_bytes is None else pool_bytes
        return dataclasses.replace(
            self, memory_budget_bytes=resident_bytes + fraction * pool)

    def layout(self):
        """The :class:`repro_torch.index.disk_layout.PageLayout` this geometry
        implies — the bridge every execution-side consumer (joins, the
        simulated machine, benchmarks) uses instead of re-deriving page
        counts from raw constants."""
        from repro_torch.index.disk_layout import PageLayout

        return PageLayout(c_ipp=self.geom.c_ipp,
                          page_bytes=self.geom.page_bytes)


# ---------------------------------------------------------------------------
# Plan-level cost summaries (shared by CostSession consumers and JoinSession)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PlanCost:
    """Model-predicted cost of one executable plan / strategy.

    The join planner emits one per candidate strategy; anything that ranks
    alternatives by predicted cost (plan selection, knob grids with attached
    execution strategies) compares these.  ``seconds`` is the Eq. 17-style
    fitted-time prediction, ``physical_ios`` the CAM cache-aware miss count
    it was derived from, and ``logical_refs`` the request mass R.
    """

    strategy: str
    seconds: float
    physical_ios: float
    logical_refs: float

    def __lt__(self, other: "PlanCost") -> bool:
        return self.seconds < other.seconds

    @classmethod
    def compose(cls, strategy: str,
                parts: Sequence["PlanCost"]) -> "PlanCost":
        """Sum component costs into one plan cost (join trees: levels run
        in sequence against disjoint buffer slices, so seconds, physical
        I/Os and request mass all add)."""
        return cls(strategy,
                   sum(p.seconds for p in parts),
                   sum(p.physical_ios for p in parts),
                   sum(p.logical_refs for p in parts))


# ---------------------------------------------------------------------------
# Page-reference profiles and the IndexModel protocol
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SortedScanPart:
    """Sorted-stream statistics feeding the ``cache_models.sorted_scan``
    family: Theorem III.1's (R, N) plus the window-coverage histogram and
    pressure-pinned re-touch count the frequency-aware closed form needs
    (see ``page_ref.sorted_workload_stats``)."""

    total_refs: float
    distinct_pages: float
    min_capacity: int = 1                 # Thm III.1 capacity premise
    coverage: Optional[torch.Tensor] = None
    pinned_retouches: float = 0.0


@dataclasses.dataclass
class WriteStreamPart:
    """Write-reference statistics of a mutating workload part.

    ``counts`` is the expected WRITE-reference histogram (the pages a write
    dirties — the eps-0 target window scaled by the structure's write
    amplification), ``total_refs`` its sample mass.  The cache solve folds
    these into the combined request histogram (a write faults its page like
    a read) and prices the dirty-eviction writeback stream on top — see
    ``cache_models.hit_rate_grid``'s ``write_*`` arguments.
    """

    counts: torch.Tensor
    total_refs: float


def _merge_write_parts(parts: Sequence[WriteStreamPart]) -> WriteStreamPart:
    """Merge write sub-streams: histograms and reference mass add."""
    if len(parts) == 1:
        return parts[0]
    counts = parts[0].counts
    for p in parts[1:]:
        counts = counts + p.counts
    return WriteStreamPart(counts=counts,
                           total_refs=sum(p.total_refs for p in parts))


@dataclasses.dataclass
class PageRefProfile:
    """Structural page-reference summary an index reports for a workload.

    ``counts`` is the Eq. 13/14 expected-reference histogram of the
    random-access (IRM) part.  Sorted probe streams carry their statistics in
    ``sorted_part`` instead (pure sorted streams set ``sorted_stream`` and
    leave ``counts`` as None; mixed workloads may have both).  Profiles built
    without a ``sorted_part`` but with the legacy ``sorted_stream`` fields
    still price through the recency closed form.
    """

    counts: Optional[torch.Tensor]
    total_refs: float                     # sample request mass R (IRM part)
    expected_dac: float                   # E[DAC] per query (all parts)
    sorted_stream: bool = False
    distinct_pages: Optional[float] = None
    min_capacity: int = 1                 # Thm III.1 capacity premise
    sorted_part: Optional[SortedScanPart] = None
    write_part: Optional[WriteStreamPart] = None


@runtime_checkable
class IndexModel(Protocol):
    """What CAM needs from a learned index — nothing design-specific."""

    family: str

    @property
    def size_bytes(self) -> float: ...    # in-memory footprint M_idx

    def knobs(self) -> Dict[str, object]: ...

    def page_ref_profile(self, workload: Workload, geom: CamGeometry,
                         device=DEFAULT_TORCH_DEVICE) -> PageRefProfile: ...


def sorted_part_for(workload: Workload, eps: int, geom: CamGeometry,
                    num_pages: int,
                    device=DEFAULT_TORCH_DEVICE) -> SortedScanPart:
    """Sorted-stream statistics of one SORTED workload (shared helper).

    The Theorem III.1 capacity premise comes from ``eps`` for uniformly
    error-bounded designs; with ``eps=0`` (no uniform bound, e.g. RMI) it is
    read off the widest observed probe window instead.
    """
    with obs.span("cam.profile.upload"):
        lo = obs.to_device(np.asarray(workload.positions, np.int64), device)
        hi = obs.to_device(np.asarray(workload.hi_positions, np.int64),
                           device)
    with obs.span("cam.profile.histogram"):
        plo, phi = page_ref.page_intervals(lo, hi, geom.c_ipp, num_pages)
        r_total, n_distinct, coverage, pinned = \
            page_ref.sorted_workload_stats(plo, phi, num_pages)
    if eps > 0:
        min_cap = 1 + int(np.ceil(2 * eps / geom.c_ipp))
    elif workload.n_queries:
        min_cap = int(obs.to_host(torch.max(phi - plo + 1)))
    else:
        min_cap = 1
    return SortedScanPart(
        total_refs=float(obs.to_host(r_total)),
        distinct_pages=float(obs.to_host(n_distinct)),
        min_capacity=min_cap, coverage=coverage,
        pinned_retouches=float(obs.to_host(pinned)))


def sorted_stream_profile(workload: Workload, geom: CamGeometry,
                          num_pages: int, eps: int = 0,
                          device=DEFAULT_TORCH_DEVICE) -> PageRefProfile:
    """Pure sorted-stream profile (any index family — windows are explicit
    positions, so no design-specific error bound enters beyond ``eps``'s
    role in the capacity premise)."""
    sp = sorted_part_for(workload, eps, geom, num_pages, device)
    return PageRefProfile(
        counts=None, total_refs=sp.total_refs,
        expected_dac=sp.total_refs / max(workload.n_queries, 1),
        sorted_stream=True, distinct_pages=sp.distinct_pages,
        min_capacity=sp.min_capacity, sorted_part=sp)


def _compulsory_coverage(sp: SortedScanPart, num_pages: int,
                         device) -> torch.Tensor:
    """Coverage surrogate for a legacy sorted part without a histogram.

    Piling the whole mass on one page makes the frequency-aware form's
    steady bound collapse to 0, so its ``[N, R]`` clamp returns exactly N —
    i.e. the compulsory closed form that coverage-less parts price through
    on the single-candidate path (``sorted_scan_misses`` with
    ``coverage=None``) — for every capacity above the premise.
    """
    cov = torch.zeros((num_pages,), dtype=torch.float32, device=device)
    cov[0] = float(np.float32(sp.total_refs))
    return cov


def _resolve_profile_executor(executor: Optional[str],
                              device: torch.device) -> str:
    """Profiling-side executor dispatch, mirroring ``PricingEngine._resolve``:
    an explicit argument wins, then the ``REPRO_ENGINE_EXECUTOR`` environment
    variable, then auto — ``device`` when the session's torch device is CUDA,
    ``host`` when it is the CPU.  ``host`` is the golden ``np.bincount``
    mixed-eps kernel; ``device`` the CUDA occupancy kernel
    (``kernels/profile_grid.py``), whose histograms are born on the card and
    chain into the pricing launch.
    """
    if executor is None:
        executor = os.environ.get("REPRO_ENGINE_EXECUTOR") or None
    if executor is None:
        executor = "device" if device.type == "cuda" else "host"
    if executor not in ("host", "device"):
        raise ValueError(f"unknown profile executor {executor!r}; expected "
                         "'host' or 'device'")
    return executor


def _exact_cap_array(values, device) -> torch.Tensor:
    """int32 page-count vector, saturating at 2^31-129 pages (≈8 TiB pools
    at 4 KiB pages).  float32 rounds integers above 2^24, which can flip the
    ``cap >= n_distinct`` compulsory-branch compare in ``hit_rate_grid``;
    int32 keeps the compare exact, and any saturated capacity is already
    deep in the compulsory regime so the clamp is lossless.
    """
    arr = np.floor(np.asarray(values, np.float64))
    return obs.to_device(np.clip(arr, -1, 2**31 - 129).astype(np.int32),
                         device)


def _as_row(row, device) -> torch.Tensor:
    """A float32 histogram row on ``device`` (numpy rows from the host
    profile executor are uploaded once here)."""
    return obs.to_device(row, device, torch.float32)


def _pad_row(row: torch.Tensor, width: int) -> torch.Tensor:
    """Zero-pad a (P,) histogram row out to ``width`` pages."""
    row = row.float()
    pad = width - int(row.shape[0])
    return row if pad <= 0 else F.pad(row, (0, pad))


def _stack_or_share(coverages: Sequence[torch.Tensor]) -> torch.Tensor:
    """One (P,) row when every candidate references the SAME stream object
    (uniform-eps grids: sorted windows are eps-independent), else a stacked
    (K, P) matrix — lets the grid solve sort the shared histogram once."""
    first = coverages[0]
    if all(c is first for c in coverages):
        return first.float()
    return torch.stack([c.float() for c in coverages])


def _merge_sorted_parts(parts: Sequence[SortedScanPart]) -> SortedScanPart:
    """Merge sorted sub-streams: coverage and R add, N is the union's size,
    the capacity premise is the widest part's."""
    if len(parts) == 1:
        return parts[0]
    coverage = parts[0].coverage
    for p in parts[1:]:
        coverage = coverage + p.coverage
    return SortedScanPart(
        total_refs=sum(p.total_refs for p in parts),
        distinct_pages=float(obs.to_host(torch.sum(coverage > 0))),
        min_capacity=max(p.min_capacity for p in parts),
        coverage=coverage,
        pinned_retouches=sum(p.pinned_retouches for p in parts))


def mixed_profile(workload: Workload, profile_part, num_pages: int,
                  device=DEFAULT_TORCH_DEVICE) -> PageRefProfile:
    """A mixed workload's profile from its parts' (``profile_part(part)``).

    Part histograms and request mass add; E[DAC] is the parts'
    query-weighted mean; sorted parts merge into ``sorted_part`` (they are
    priced by the policy-aware sorted-scan model, not the IRM fixed point)
    and mutating parts into ``write_part``.
    """
    counts = torch.zeros((num_pages,), dtype=torch.float32, device=device)
    total = 0.0
    dac_mass = 0.0
    sorted_parts = []
    write_parts = []
    for part in workload.parts:
        prof = profile_part(part)
        dac_mass += prof.expected_dac * part.n_queries
        if prof.sorted_part is not None:
            sorted_parts.append(prof.sorted_part)
        if prof.write_part is not None:
            write_parts.append(prof.write_part)
        if not prof.sorted_stream:
            counts = counts + prof.counts
            total += prof.total_refs
    e_dac = dac_mass / max(workload.n_queries, 1)
    wp = _merge_write_parts(write_parts) if write_parts else None
    if not sorted_parts:
        return PageRefProfile(counts, total, e_dac, write_part=wp)
    sp = _merge_sorted_parts(sorted_parts)
    if total <= 0.0 and wp is None:
        # every part is sorted: still a pure sorted stream
        return PageRefProfile(
            counts=None, total_refs=sp.total_refs, expected_dac=e_dac,
            sorted_stream=True, distinct_pages=sp.distinct_pages,
            min_capacity=sp.min_capacity, sorted_part=sp)
    return PageRefProfile(counts, total, e_dac, sorted_part=sp,
                          write_part=wp)


def uniform_eps_profile(workload: Workload, eps: int, geom: CamGeometry,
                        n: Optional[int] = None,
                        write_amp: float = 1.0,
                        device=DEFAULT_TORCH_DEVICE) -> PageRefProfile:
    """Shared profile for any uniformly error-bounded design (PGM, RadixSpline).

    Dispatches on the workload shape; mixed workloads sum part histograms,
    with sorted parts accumulated separately into ``sorted_part`` (they are
    priced by the policy-aware sorted-scan model, not the IRM fixed point)
    and mutating parts into ``write_part``.  A write locates its target
    through the same eps-window search a point lookup pays (read
    references), then dirties the target page itself — ``write_amp`` scales
    the INSERT dirty mass (structure-dependent shifting: gapped arrays /
    node splits touch more than one page per insert; updates and deletes
    stay in place).  Histograms are made on ``device``.
    """
    n = int(n if n is not None else workload.n)
    num_pages = geom.num_pages(n)

    def positions(arr):
        return torch.as_tensor(np.asarray(arr, np.int64), device=device)

    if workload.kind == POINT:
        counts, total = page_ref.point_page_refs(
            positions(workload.positions), int(eps),
            geom.c_ipp, num_pages)
        e_dac = float(dac.expected_dac(eps, geom.c_ipp, geom.strategy))
        return PageRefProfile(counts, float(total), e_dac)
    if workload.kind in WRITE_KINDS:
        counts, total = page_ref.point_page_refs(
            positions(workload.positions), int(eps),
            geom.c_ipp, num_pages)
        wcounts, wtotal = page_ref.point_page_refs(
            positions(workload.positions), 0,
            geom.c_ipp, num_pages)
        amp = float(write_amp) if workload.kind == INSERT else 1.0
        e_dac = float(dac.expected_dac(eps, geom.c_ipp, geom.strategy)) + amp
        wp = WriteStreamPart(counts=wcounts * float(np.float32(amp)),
                             total_refs=float(wtotal) * amp)
        return PageRefProfile(counts, float(total), e_dac, write_part=wp)
    if workload.kind == RANGE:
        counts, total = page_ref.range_page_refs(
            positions(workload.positions),
            positions(workload.hi_positions),
            int(eps), geom.c_ipp, num_pages, n)
        e_dac = float(total) / max(workload.n_queries, 1)
        return PageRefProfile(counts, float(total), e_dac)
    if workload.kind == SORTED:
        return sorted_stream_profile(workload, geom, num_pages, eps=eps,
                                     device=device)
    if workload.kind == MIXED:
        return mixed_profile(
            workload,
            lambda part: uniform_eps_profile(part, eps, geom, n,
                                             write_amp=write_amp,
                                             device=device),
            num_pages, device)
    raise UnsupportedWorkloadError(workload.kind)


@dataclasses.dataclass(frozen=True)
class UniformEpsModel:
    """Un-built stand-in for any error-bounded index: knob metadata only.

    Lets tuners price an (eps, size) candidate — size typically from a fitted
    power law — without constructing the index (paper §V-B).
    """

    eps: int
    n: int
    size_bytes: float
    family: str = "uniform-eps"

    def knobs(self) -> Dict[str, object]:
        return {"eps": {"value": self.eps, "kind": "error_bound",
                        "tunable": True}}

    def page_ref_profile(self, workload: Workload, geom: CamGeometry,
                         device=DEFAULT_TORCH_DEVICE) -> PageRefProfile:
        return uniform_eps_profile(workload, self.eps, geom, self.n,
                                   device=device)


# ---------------------------------------------------------------------------
# Grid candidates / results
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GridCandidate:
    """One knob configuration in an ``estimate_grid`` sweep.

    Either ``eps`` (uniform error bound — enables the fully batched kernel,
    no index build needed) or ``index`` (a built :class:`IndexModel`, e.g. an
    RMI whose per-leaf mixture has no uniform eps) must be set.
    """

    knob: object
    size_bytes: float
    eps: Optional[int] = None
    index: Optional[IndexModel] = None

    def __post_init__(self):
        if self.eps is None and self.index is None:
            raise ValueError("GridCandidate needs eps or index")


class SkippedCandidate(NamedTuple):
    """A grid candidate dropped from a sweep, with the reason why —
    budget-infeasible, or a profile the candidate's index cannot produce."""

    knob: object
    reason: str


@dataclasses.dataclass
class GridProfiles:
    """Per-candidate structural profiles from ONE batched profiling pass.

    This is the workload-dependent half of ``estimate_grid``, split out so
    capacity-dependent consumers (the tuner's joint knob x buffer-split
    search) can price the SAME profiles at many capacities without
    re-profiling: everything here is independent of the buffer capacity, and
    :meth:`CostSession.solve_profiles` turns (row, capacity) pairs into hit
    rates with a single batched cache-model solve.

    ``caps`` are the full-budget capacities (``System.capacity_for`` of each
    candidate's footprint) — the maximal buffer split each knob can take.
    """

    knobs: Tuple[object, ...]
    counts: torch.Tensor                    # (K, P) IRM histograms (device)
    totals: np.ndarray                      # (K,) sample IRM request mass
    dacs: np.ndarray                        # (K,) E[DAC] per query
    sizes: np.ndarray                       # (K,) index footprints (bytes)
    caps: np.ndarray                        # (K,) full-budget capacities
    sparts: Tuple[Optional[SortedScanPart], ...]
    skipped: Tuple[SkippedCandidate, ...]
    scale: float                            # full/sample request-volume ratio
    n_queries: int
    #: Per-candidate write streams ((), the read-only default, means none).
    wparts: Tuple[Optional[WriteStreamPart], ...] = ()

    def sorted_refs(self, i: int) -> float:
        sp = self.sparts[i]
        return sp.total_refs if sp is not None else 0.0

    def wpart(self, i: int) -> Optional[WriteStreamPart]:
        return self.wparts[i] if self.wparts else None

    def write_refs(self, i: int) -> float:
        wp = self.wpart(i)
        return wp.total_refs if wp is not None else 0.0

    @classmethod
    def from_accumulated(cls, system, knobs, counts, totals, dac_mass,
                         sizes, sparts, n_queries,
                         skipped: Sequence["SkippedCandidate"] = (),
                         wparts: Sequence[Optional[WriteStreamPart]] = ()
                         ) -> "GridProfiles":
        """Assemble profiles from incrementally accumulated sums.

        The serving-sketch entry point: everything a profile row holds is a
        per-query-mass SUM over the workload (histogram counts, request
        mass R, DAC access mass, sorted coverage), so a sliding-window
        sketch can maintain those sums per chunk and re-derive the exact
        profile of the whole window without replaying it — ``dac_mass`` is
        the accumulated ``E[DAC] * n_queries`` mass and is normalized back
        to a per-query expectation here.  ``scale`` is 1.0 by construction:
        the sketch sees every event, sampling (CAM-x) happens upstream of
        ingestion if at all.
        """
        sizes_arr = np.asarray(sizes, np.float64)
        nq = max(int(n_queries), 1)
        return cls(
            knobs=tuple(knobs),
            counts=obs.to_device(
                counts, resolve_torch_device(system.torch_device),
                torch.float32),
            totals=np.asarray(totals, np.float64),
            dacs=np.asarray(dac_mass, np.float64) / nq,
            sizes=sizes_arr,
            caps=np.asarray([system.capacity_for(s) for s in sizes_arr],
                            np.int64),
            sparts=tuple(sparts),
            skipped=tuple(skipped),
            scale=1.0,
            n_queries=int(n_queries),
            wparts=tuple(wparts))


@dataclasses.dataclass
class GridResult:
    """All candidate estimates + argmin, from one batched pass."""

    estimates: Dict[object, CamEstimate]
    best_knob: object
    seconds: float
    skipped: Tuple[SkippedCandidate, ...] = ()

    @property
    def best(self) -> CamEstimate:
        return self.estimates[self.best_knob]

    @property
    def est_io(self) -> float:
        return self.best.io_per_query


# ---------------------------------------------------------------------------
# The session
# ---------------------------------------------------------------------------

class CostSession:
    """Reusable estimation context bound to one :class:`System`.

    Holds the sampled-workload cache so repeated ``estimate``/``estimate_grid``
    calls over the same workload (the tuning loop) never re-sample or
    re-locate queries.
    """

    _SAMPLE_CACHE_MAX = 16

    def __init__(self, system: System):
        self.system = system
        self.device = resolve_torch_device(system.torch_device)
        self._sample_cache: Dict[tuple, tuple] = {}
        self._engine = None

    @property
    def engine(self):
        """The session's :class:`~repro_torch.engine.table.PricingEngine` —
        lazily built (the engine layer imports this module)."""
        if self._engine is None:
            from repro_torch.engine import PricingEngine
            self._engine = PricingEngine(self)
        return self._engine

    # ------------------------------------------------------------------ single
    def estimate(self, index: IndexModel, workload: Workload,
                 sample_rate: float = 1.0, seed: int = 0) -> CamEstimate:
        """Algorithm 1 for one (index, workload) pair."""
        t0 = time.perf_counter()
        wl = self._sampled(workload, sample_rate, seed)
        prof = index.page_ref_profile(wl, self.system.geom,
                                      device=self.device)
        cap = self.system.capacity_for(index.size_bytes)
        return self._finish(prof, wl, cap, t0)

    # ------------------------------------------------------------------- grid
    def estimate_grid(self, candidates: Sequence[GridCandidate],
                      workload: Workload, sample_rate: float = 1.0,
                      seed: int = 0, batch_mixed_eps: bool = True,
                      executor: Optional[str] = None) -> GridResult:
        """Estimate a whole knob grid in one batched pass.

        Page-ref state (positions, scatter targets) is shared across
        candidates; histograms for uniform-eps candidates come from the
        batched grid kernel, index-backed candidates exposing
        ``point_ref_eps`` (RMI) batch through the grouped mixed-eps kernel
        (``batch_mixed_eps=False`` falls back to per-candidate mixture
        histograms — the legacy per-branch path kept for golden equivalence
        and benchmarking); ALL hit-rate fixed points then solve in a single
        lockstep bisection.  Sorted workloads batch through the batched
        sorted-scan solve (one shared coverage profile — see
        ``_sorted_grid``), and mixed workloads may contain sorted parts,
        composed with the IRM solve inside ``cache_models.hit_rate_grid``.
        Candidates that are budget-infeasible or cannot profile the
        workload are recorded in ``GridResult.skipped`` with their reasons.
        """
        t0 = time.perf_counter()
        wl = self._sampled(workload, sample_rate, seed)
        feasible, skipped = self._feasible(candidates)
        if wl.kind == SORTED:
            return self._sorted_grid(feasible, skipped, wl, t0)
        prof = self._profile_batch(feasible, wl, skipped, batch_mixed_eps,
                                   executor)
        from repro_torch.engine import PriceTable
        sol = self.engine.price(PriceTable.max_capacity(
            prof, self.system.memory_budget_bytes))
        h, n_distinct = sol.hit_rates, sol.distinct

        elapsed = time.perf_counter() - t0
        per = elapsed / max(len(prof.knobs), 1)
        estimates: Dict[object, CamEstimate] = {}
        for i, knob in enumerate(prof.knobs):
            io = (1.0 - float(h[i])) * float(prof.dacs[i])
            estimates[knob] = CamEstimate(
                io_per_query=io, hit_rate=float(h[i]),
                dac=float(prof.dacs[i]), capacity_pages=int(prof.caps[i]),
                total_refs=(float(prof.totals[i]) + prof.sorted_refs(i)
                            + prof.write_refs(i)) * prof.scale,
                distinct_pages=float(n_distinct[i]),
                estimation_seconds=per, policy=self.system.policy,
                device_cost=self._device_cost(io))
        best = min(estimates, key=lambda k: estimates[k].io_per_query)
        return GridResult(estimates, best, elapsed, tuple(prof.skipped))

    @obs.traced("cam.profile")
    def grid_profiles(self, candidates: Sequence[GridCandidate],
                      workload: Workload, sample_rate: float = 1.0,
                      seed: int = 0, batch_mixed_eps: bool = True,
                      executor: Optional[str] = None) -> GridProfiles:
        """Capacity-independent profiles of a knob grid (one batched pass).

        The profiling half of :meth:`estimate_grid`: feasibility filtering,
        the uniform-eps banded-matmul kernels, the grouped mixed-eps kernel
        for batchable index-backed candidates, per-candidate profiles for
        the rest.  Pair with :meth:`solve_profiles` to price the SAME
        profiles at arbitrary (row, capacity) combinations — the engine
        behind the tuner's joint (knob x buffer-split) search.

        ``executor`` picks the mixed-eps kernel: ``"host"`` (the golden
        ``np.bincount`` path), ``"device"`` (the CUDA occupancy kernel of
        ``kernels/profile_grid.py`` — histograms stay on the card and chain
        into the pricing launch), or ``None`` for the engine's dispatch rule
        (``REPRO_ENGINE_EXECUTOR``, then auto by torch device).
        """
        wl = self._sampled(workload, sample_rate, seed)
        feasible, skipped = self._feasible(candidates)
        return self._profile_batch(feasible, wl, skipped, batch_mixed_eps,
                                   executor)

    def grid_profiles_grouped(self, groups, sample_rate: float = 1.0,
                              seed: int = 0, batch_mixed_eps: bool = True,
                              executor: Optional[str] = None
                              ) -> GridProfiles:
        """Profiles of MANY (key, candidates, workload) groups — ONE pass.

        The batched-over-shards generalization of :meth:`grid_profiles`:
        each group is profiled against its OWN workload (a shard's routed
        sub-workload over its local page range), and the per-group rows are
        concatenated into a single :class:`GridProfiles` whose knob keys
        are ``(group_key, knob)`` pairs.  Histograms (and sorted coverage)
        are zero-padded to the widest group's page span — zero columns are
        invisible to ``hit_rate_grid`` (no mass, no distinct pages) — so
        one :meth:`solve_profiles` call can then price ANY (group, knob,
        capacity) combination of the whole fleet in a single
        ``cache_models.hit_rate_grid`` solve.  This is what lets a sharded
        search run with zero per-shard model calls: S shards x B boundary
        candidates collapse into one profiling pass and one solve.
        """
        parts = []
        for key, cands, wl in groups:
            wls = self._sampled(wl, sample_rate, seed)
            feasible, skipped = self._feasible(cands)
            parts.append((key, self._profile_batch(feasible, wls, skipped,
                                                   batch_mixed_eps,
                                                   executor)))
        if not parts:
            raise ValueError("grid_profiles_grouped needs at least one group")
        scales = {p.scale for _, p in parts}
        if len(scales) > 1:
            raise ValueError(f"groups disagree on sample scale: {scales}")
        width = max(int(p.counts.shape[1]) for _, p in parts)

        def pad(arr: torch.Tensor) -> torch.Tensor:
            w = int(arr.shape[-1])
            if w == width:
                return arr
            return F.pad(arr, (0, width - w))

        sparts = []
        for _, p in parts:
            for sp in p.sparts:
                if sp is not None and sp.coverage is not None:
                    sp = dataclasses.replace(sp, coverage=pad(sp.coverage))
                sparts.append(sp)
        wparts = []
        for _, p in parts:
            for wp in (p.wparts if p.wparts else (None,) * len(p.knobs)):
                if wp is not None:
                    wp = dataclasses.replace(wp, counts=pad(wp.counts))
                wparts.append(wp)
        return GridProfiles(
            knobs=tuple((key, kn) for key, p in parts for kn in p.knobs),
            counts=torch.cat([pad(p.counts) for _, p in parts]),
            totals=np.concatenate([p.totals for _, p in parts]),
            dacs=np.concatenate([p.dacs for _, p in parts]),
            sizes=np.concatenate([p.sizes for _, p in parts]),
            caps=np.concatenate([p.caps for _, p in parts]),
            sparts=tuple(sparts),
            skipped=tuple(SkippedCandidate((key, s.knob), s.reason)
                          for key, p in parts for s in p.skipped),
            scale=float(scales.pop()),
            n_queries=sum(p.n_queries for _, p in parts),
            wparts=(tuple(wparts) if any(wp is not None for wp in wparts)
                    else ()))

    def solve_profiles(self, profiles: GridProfiles, capacities,
                       rows: Optional[np.ndarray] = None,
                       policy: Optional[str] = None,
                       policies=None):
        """Hit rates of profile rows at given capacities — ONE batched solve.

        ``rows[i]`` names the profile row that ``capacities[i]`` applies to
        (default: row i), so a (knob x split) table — every knob priced at
        every candidate buffer split — solves in a single
        ``cache_models.hit_rate_grid`` call, the many-histogram
        generalization of the ``hit_rate_curve`` capacity-curve evaluator.
        Mixed workloads' sorted parts compose inside the same call through
        ``sorted_scan_hit_rate_grid`` (which ``sorted_scan_miss_curve``
        wraps), preserving the per-candidate composition semantics of
        ``_finish``.  Returns ``(hit_rates, distinct_pages)`` float64
        arrays aligned with ``capacities``.

        ``policy`` overrides the system's eviction policy for every cell;
        ``policies`` gives a PER-CELL policy column (names, or ids into
        ``cache_models.POLICIES`` with -1 = the session policy — the
        multi-policy ``PriceTable.pols`` contract): cells group by policy
        and solve as one ``hit_rate_grid`` dispatch per distinct policy
        (<= 3), scattered back in cell order.
        """
        idx = (np.arange(len(profiles.knobs), dtype=np.int64)
               if rows is None else np.asarray(rows, np.int64))
        if policies is not None:
            base = policy if policy is not None else self.system.policy
            names = [base if p == -1 or p is None
                     else (p if isinstance(p, str)
                           else cache_models.POLICIES[int(p)])
                     for p in np.asarray(policies).tolist()]
            caps_in = np.asarray(capacities)
            h_out = np.empty(len(names), np.float64)
            nd_out = np.empty(len(names), np.float64)
            for pol in sorted(set(names)):
                m = np.asarray([nm == pol for nm in names])
                h_out[m], nd_out[m] = self.solve_profiles(
                    profiles, caps_in[m], rows=idx[m], policy=pol)
            return h_out, nd_out
        policy = policy if policy is not None else self.system.policy
        dev = profiles.counts.device
        counts = (profiles.counts if rows is None
                  else profiles.counts[obs.to_device(idx, dev)])
        sample_refs = obs.to_device(profiles.totals[idx], dev, torch.float32)
        full_refs = sample_refs * profiles.scale
        caps_arr = _exact_cap_array(capacities, dev)
        num_pages = int(profiles.counts.shape[1])
        wkw = {}
        wps = [profiles.wpart(i) for i in idx]
        if any(wp is not None for wp in wps):
            # Mutating mix: fold write streams into the solve (combined
            # request histogram + dirty-eviction writeback, see
            # hit_rate_grid).  _stack_or_share keeps the common
            # shared-stream case (write windows are knob-independent for
            # uniform grids) a single (P,) row.
            zero_w = torch.zeros((num_pages,), dtype=torch.float32,
                                 device=dev)
            w_refs = obs.to_device([wp.total_refs if wp is not None else 0.0
                                    for wp in wps], dev, torch.float32)
            wkw = dict(
                write_counts=_stack_or_share(
                    [wp.counts if wp is not None else zero_w for wp in wps]),
                write_refs=w_refs,
                write_full_refs=w_refs * profiles.scale)
        sparts = [profiles.sparts[i] for i in idx]
        surrogate = {}
        if any(sp is not None for sp in sparts):
            # Mixed workload with sorted sub-streams: compose the IRM solve
            # with the policy-aware sorted-scan model inside hit_rate_grid.
            zero = SortedScanPart(0.0, 0.0, 1,
                                  torch.zeros((num_pages,),
                                              dtype=torch.float32,
                                              device=dev), 0.0)
            sps = [sp if sp is not None else zero for sp in sparts]
            # coverage-less legacy parts: remember the true N per row, price
            # through the compulsory-equivalent surrogate histogram
            for i, sp in enumerate(sps):
                if sp.coverage is None:
                    surrogate[i] = sp.distinct_pages
                    sps[i] = dataclasses.replace(
                        sp, coverage=_compulsory_coverage(sp, num_pages,
                                                          dev))
            s_refs = obs.to_device([sp.total_refs for sp in sps], dev,
                                   torch.float32)
            h, n_distinct = cache_models.hit_rate_grid(
                policy, counts, sample_refs, full_refs, caps_arr,
                sorted_coverage=_stack_or_share(
                    [sp.coverage for sp in sps]),
                sorted_refs=s_refs,
                sorted_distinct=_exact_cap_array(
                    [sp.distinct_pages for sp in sps], dev),
                sorted_pinned=obs.to_device(
                    [sp.pinned_retouches for sp in sps], dev, torch.float32),
                sorted_min_caps=_exact_cap_array(
                    [sp.min_capacity for sp in sps], dev),
                sorted_full_refs=s_refs * profiles.scale, **wkw)
        else:
            h, n_distinct = cache_models.hit_rate_grid(
                policy, counts, sample_refs, full_refs, caps_arr, **wkw)
        h = _np64(h)
        n_distinct = _np64(n_distinct)
        for i, true_n in surrogate.items():
            # report the same footprint _finish's coverage-less fallback
            # does (IRM distinct + the part's N), not the surrogate's page
            n_distinct[i] = float(obs.to_host(torch.sum(counts[i] > 0))) \
                + true_n
        return h, n_distinct

    def _feasible(self, candidates: Sequence[GridCandidate]):
        """Budget-feasibility filter (Alg. 1 l. 15) with typed skip reasons."""
        feasible, skipped = [], []
        for c in candidates:
            if self.system.capacity_for(c.size_bytes) >= 1:
                feasible.append(c)
            else:
                skipped.append(SkippedCandidate(
                    c.knob,
                    f"memory budget {self.system.memory_budget_bytes:.0f} B "
                    f"leaves no buffer page after a {c.size_bytes:.0f} B "
                    f"index"))
        if not feasible:
            raise ValueError("memory budget too small for any candidate index")
        return feasible, skipped

    def _profile_batch(self, feasible, wl: Workload, skipped,
                       batch_mixed_eps: bool,
                       executor: Optional[str] = None) -> GridProfiles:
        """Assemble per-candidate (histogram, R, E[DAC], sorted part) rows."""
        geom = self.system.geom
        uniform = [c for c in feasible if c.index is None]
        backed = [c for c in feasible if c.index is not None]

        rows, totals, dacs, knobs, sparts, sizes = [], [], [], [], [], []
        wparts = []
        if uniform:
            counts_u, totals_u, dacs_u, spart_u, wpart_u = self._uniform_grid(
                uniform, wl)
            rows.extend(counts_u)
            totals.extend(totals_u)
            dacs.extend(dacs_u)
            knobs.extend(c.knob for c in uniform)
            sizes.extend(c.size_bytes for c in uniform)
            # Sorted windows are eps-independent; only the Thm III.1 capacity
            # premise varies across uniform-eps candidates (eps <= 0 keeps
            # the shared profile's widest-observed-window premise, matching
            # sorted_part_for's single-candidate dispatch).
            sparts.extend(
                None if spart_u is None
                else spart_u if c.eps <= 0
                else dataclasses.replace(
                    spart_u,
                    min_capacity=1 + int(np.ceil(2 * c.eps / geom.c_ipp)))
                for c in uniform)
            # Write target windows are eps-independent too: ONE shared
            # stream object per grid (solve_profiles' _stack_or_share then
            # keeps a single (P,) row for the whole grid).
            wparts.extend(wpart_u for _ in uniform)
        mixed_rows = self._mixed_eps_rows(backed, wl, skipped,
                                          batch_mixed_eps, executor)
        for c in backed:
            if id(c) in mixed_rows:
                entry = mixed_rows[id(c)]
                if entry is None:       # routing raised: skip recorded
                    continue
                counts_c, total_c, dac_c, sp_c = entry
                rows.append(counts_c)
                totals.append(total_c)
                dacs.append(dac_c)
                sparts.append(sp_c)
                wparts.append(None)
                knobs.append(c.knob)
                sizes.append(c.size_bytes)
                continue
            try:
                prof = c.index.page_ref_profile(wl, geom, device=self.device)
            except UnsupportedWorkloadError as e:
                skipped.append(SkippedCandidate(c.knob, str(e)))
                continue
            if prof.counts is None:
                # A mixed workload whose parts are ALL sorted profiles as a
                # pure sorted stream (counts=None, total_refs=R_sorted):
                # the IRM part is empty, everything lives in sorted_part
                # (synthesized from the legacy fields if a third-party
                # profile carries only those).
                sp = prof.sorted_part or SortedScanPart(
                    prof.total_refs, float(prof.distinct_pages),
                    prof.min_capacity)
                if sp.coverage is not None:
                    width = sp.coverage.shape[0]
                elif wl.n is not None:
                    width = geom.num_pages(int(wl.n))
                else:
                    raise ValueError("Workload.n (key-file size) required "
                                     "for grid estimation")
                rows.append(torch.zeros((width,), dtype=torch.float32,
                                        device=self.device))
                totals.append(0.0)
                sparts.append(sp)
            else:
                rows.append(prof.counts)
                totals.append(prof.total_refs)
                sparts.append(prof.sorted_part)
            wparts.append(prof.write_part)
            dacs.append(prof.expected_dac)
            knobs.append(c.knob)
            sizes.append(c.size_bytes)
        if not knobs:
            raise UnsupportedWorkloadError(
                wl.kind,
                detail="no grid candidate could profile this workload ("
                       + "; ".join(s.reason for s in skipped) + ")")

        sizes_arr = np.asarray(sizes, np.float64)
        rows = [_as_row(r, self.device) for r in rows]
        widths = [int(r.shape[0]) for r in rows]
        if len(set(widths)) > 1:
            # Index-backed candidates may live in per-knob SLOT spaces
            # (gapped/fill-factor layouts: more slack = more pages), so
            # histogram rows can differ in width.  Zero-pad to the widest:
            # absent pages carry no reference mass, so probabilities,
            # n_distinct and the fixed points are unchanged.
            width = max(widths)
            rows = [_pad_row(r, width) for r in rows]
            sparts = [sp if sp is None or sp.coverage is None
                      else dataclasses.replace(
                          sp, coverage=_pad_row(sp.coverage, width))
                      for sp in sparts]
            wparts = [wp if wp is None
                      else WriteStreamPart(_pad_row(wp.counts, width),
                                           wp.total_refs)
                      for wp in wparts]
        return GridProfiles(
            knobs=tuple(knobs),
            counts=torch.stack(rows),
            totals=np.asarray(totals, np.float64),
            dacs=np.asarray(dacs, np.float64),
            sizes=sizes_arr,
            caps=np.asarray([self.system.capacity_for(s)
                             for s in sizes_arr], np.int64),
            sparts=tuple(sparts),
            skipped=tuple(skipped),
            scale=float(wl.scale),
            n_queries=int(wl.n_queries),
            wparts=(tuple(wparts) if any(wp is not None for wp in wparts)
                    else ()))

    def _mixed_eps_rows(self, backed, wl: Workload, skipped,
                        batch_mixed_eps: bool,
                        executor: Optional[str] = None):
        """Batched §V-C rows of the routing candidates (RMI adapters).

        Index-backed candidates exposing ``point_ref_eps`` (and, for
        ranges, ``range_ref_eps``) hand over per-query quantized leaf
        error bounds: every candidate routes first (span ``cam.route``),
        then a point, range or sorted workload, or a mix of them, profiles
        the whole grid in three passes that compose as the uniform-eps path
        composes a mixed batch:

        * points: ONE grouped banded pass over every candidate's bounds —
          references grouped by LUT radius ACROSS candidates — on the
          resolved profile executor: ``host`` is the golden
          ``page_ref.point_page_refs_mixed_eps_grid`` bincount kernel,
          ``device`` the CUDA occupancy kernel (``kernels.profile_grid``)
          whose rows are card tensors from birth;
        * ranges: ONE difference-array pass over every candidate's
          per-endpoint spans (``page_ref.range_page_refs_bounds_grid`` on
          the session's device, whichever the executor), span
          ``cam.profile.range``; a range's E[DAC] mass is its page count;
        * sorted probes: windows that do not depend on the bound, so ONE
          :class:`SortedScanPart`, its capacity premise read off the widest
          observed window, serves every candidate.

        Returns ``{id(candidate): (counts_row, total, e_dac, sorted_part)
        | None}`` — ``None`` marks a candidate whose routing raised (skip
        recorded); an empty dict leaves every candidate to its own
        ``page_ref_profile``.
        """
        parts = wl.parts if wl.kind == MIXED else (wl,)
        kinds = {p.kind for p in parts}
        if not batch_mixed_eps or not kinds <= {POINT, RANGE, SORTED}:
            return {}
        need = ("point_ref_eps",) + (("range_ref_eps",) if RANGE in kinds
                                     else ())
        batchable = [c for c in backed
                     if all(hasattr(c.index, m) for m in need)]
        if not batchable:
            return {}
        geom = self.system.geom
        out, ok, bounds = {}, [], []
        with obs.span("cam.route"):
            for c in batchable:
                try:
                    bounds.append([
                        c.index.point_ref_eps(p, geom) if p.kind == POINT
                        else c.index.range_ref_eps(p, geom)
                        if p.kind == RANGE else None for p in parts])
                except UnsupportedWorkloadError as e:
                    skipped.append(SkippedCandidate(c.knob, str(e)))
                    out[id(c)] = None
                    continue
                ok.append(c)
        if not ok:
            return out
        num_pages = geom.num_pages(int(ok[0].index.n))
        on_device = _resolve_profile_executor(executor,
                                              self.device) == "device"
        k = len(ok)
        counts = None
        totals = np.zeros(k)
        dac_mass = np.zeros(k)
        point_dacs = None
        sorted_parts = []
        for j, p in enumerate(parts):
            if p.kind == SORTED:
                sp = sorted_part_for(p, 0, geom, num_pages, self.device)
                sorted_parts.append(sp)
                dac_mass += sp.total_refs
                continue
            if p.kind == POINT:
                eps_rows = np.stack([np.asarray(b[j][0], np.int64)
                                     for b in bounds])
                point_dacs = np.asarray([float(b[j][1]) for b in bounds])
                with obs.span("cam.profile.histogram"):
                    if on_device:
                        from repro_torch.kernels import \
                            profile_grid as _device_profile
                        c_p, t_p = \
                            _device_profile.point_page_refs_mixed_eps_grid(
                                p.positions, eps_rows, geom.c_ipp,
                                num_pages, device=self.device)
                    else:
                        c_p, t_p = page_ref.point_page_refs_mixed_eps_grid(
                            p.positions, eps_rows, geom.c_ipp, num_pages)
                dac_mass += point_dacs * p.n_queries
            else:
                with obs.span("cam.profile.range"):
                    start, end = page_ref.range_page_spans(
                        p.positions, p.hi_positions,
                        np.stack([b[j][0] for b in bounds]),
                        np.stack([b[j][1] for b in bounds]), geom.c_ipp,
                        int(ok[0].index.n))
                    t_p = (end - start + 1).sum(axis=1).astype(np.float64)
                    c_p = page_ref.range_page_refs_bounds_grid(
                        *obs.to_device(np.stack([start, end]).astype(
                            np.int32), self.device), num_pages)
                    if not on_device:   # the host point rows are numpy
                        c_p = obs.to_host(c_p)
                dac_mass += t_p
            counts = c_p if counts is None else counts + c_p
            totals = totals + t_p
        if counts is None:          # every part sorted: an empty IRM part
            counts = torch.zeros((k, num_pages), dtype=torch.float32,
                                 device=self.device)
        # a point workload keeps each candidate's E[DAC] as routed
        dacs = (point_dacs if wl.kind == POINT
                else dac_mass / max(wl.n_queries, 1))
        sp = _merge_sorted_parts(sorted_parts) if sorted_parts else None
        for i, c in enumerate(ok):
            out[id(c)] = (counts[i], float(totals[i]), float(dacs[i]), sp)
        return out

    def _sorted_grid(self, feasible, skipped, wl: Workload,
                     t0: float) -> GridResult:
        """Batched sorted-stream grid (the batched counterpart of the
        point/range banded-matmul kernels).

        The probe windows of a sorted stream do not depend on eps, so ONE
        shared (R, N, coverage, pinned) profile serves every uniform-eps
        candidate — only the capacity and the Theorem III.1 premise vary —
        and all candidates solve through one call of
        ``cache_models.sorted_scan_hit_rate_grid``.
        """
        geom = self.system.geom
        shared = None
        entries = []          # (candidate, SortedScanPart, capacity)
        for c in feasible:
            if c.index is not None:
                try:
                    prof = c.index.page_ref_profile(wl, geom,
                                                    device=self.device)
                except UnsupportedWorkloadError as e:
                    skipped.append(SkippedCandidate(c.knob, str(e)))
                    continue
                sp = prof.sorted_part
                if sp is None:
                    sp = SortedScanPart(prof.total_refs,
                                        float(prof.distinct_pages),
                                        prof.min_capacity)
            else:
                if shared is None:
                    if wl.n is None:
                        raise ValueError("Workload.n (key-file size) required "
                                         "for grid estimation")
                    shared = sorted_part_for(wl, 0, geom,
                                             geom.num_pages(int(wl.n)),
                                             self.device)
                # eps <= 0 keeps the shared profile's widest-observed-window
                # premise, matching sorted_part_for's dispatch.
                sp = (shared if c.eps <= 0 else dataclasses.replace(
                    shared,
                    min_capacity=1 + int(np.ceil(2 * c.eps / geom.c_ipp))))
            entries.append((c, sp, self.system.capacity_for(c.size_bytes)))
        if not entries:
            raise UnsupportedWorkloadError(
                wl.kind,
                detail="no grid candidate could profile this workload ("
                       + "; ".join(s.reason for s in skipped) + ")")

        batched = [e for e in entries if e[1].coverage is not None]
        if batched:
            dev = self.device
            h_arr = _np64(cache_models.sorted_scan_hit_rate_grid(
                self.system.policy,
                _stack_or_share([sp.coverage for _, sp, _ in batched]),
                torch.as_tensor([sp.total_refs for _, sp, _ in batched],
                                dtype=torch.float32, device=dev),
                _exact_cap_array([sp.distinct_pages for _, sp, _ in batched],
                                 dev),
                torch.as_tensor([sp.pinned_retouches for _, sp, _ in batched],
                                dtype=torch.float32, device=dev),
                _exact_cap_array([cap for _, _, cap in batched], dev),
                _exact_cap_array([sp.min_capacity for _, sp, _ in batched],
                                 dev)))
        hit_rates = {}
        k = 0
        for c, sp, cap in entries:
            if sp.coverage is not None:
                hit_rates[c.knob] = float(h_arr[k])
                k += 1
            else:   # profile without a coverage histogram: recency form
                hit_rates[c.knob] = cache_models.sorted_scan_hit_rate(
                    self.system.policy, cap, total_refs=sp.total_refs,
                    distinct_pages=sp.distinct_pages,
                    min_capacity=sp.min_capacity)

        elapsed = time.perf_counter() - t0
        per = elapsed / max(len(entries), 1)
        estimates: Dict[object, CamEstimate] = {}
        for c, sp, cap in entries:
            h = hit_rates[c.knob]
            e_dac = sp.total_refs / max(wl.n_queries, 1)
            io = (1.0 - h) * e_dac
            estimates[c.knob] = CamEstimate(
                io_per_query=io, hit_rate=h, dac=e_dac, capacity_pages=cap,
                total_refs=sp.total_refs, distinct_pages=sp.distinct_pages,
                estimation_seconds=per,
                policy=self._sorted_label(cap, sp),
                device_cost=self._device_cost(io))
        best = min(estimates, key=lambda kn: estimates[kn].io_per_query)
        return GridResult(estimates, best, elapsed, tuple(skipped))

    def _sorted_label(self, cap: int, sp: SortedScanPart) -> str:
        """Which sorted-scan form priced this estimate (CamEstimate.policy)."""
        freq_aware = (self.system.policy not in cache_models.RECENCY_POLICIES
                      and sp.coverage is not None
                      and sp.min_capacity <= cap < sp.distinct_pages)
        return (f"sorted-{self.system.policy}" if freq_aware
                else "sorted-closed-form")

    # -------------------------------------------------------------- internals
    def _uniform_grid(self, cands: Sequence[GridCandidate], wl: Workload):
        """(counts rows, totals, dacs, sorted part) for uniform-eps
        candidates, batched.

        Point/range parts accumulate into the shared banded-matmul
        histograms; sorted parts accumulate into ONE merged
        :class:`SortedScanPart` (their windows are eps-independent) whose
        capacity premise the caller re-derives per candidate.
        """
        geom = self.system.geom
        if wl.n is None:
            raise ValueError("Workload.n (key-file size) required for "
                             "grid estimation")
        num_pages = geom.num_pages(int(wl.n))
        dev = self.device
        eps_arr = obs.to_device([c.eps for c in cands], dev, torch.int64)
        eps_f = np.asarray([c.eps for c in cands], np.float64)
        dac_per_query = _np64(
            dac.expected_dac(eps_f, geom.c_ipp, geom.strategy))
        sorted_parts = []
        write_parts = []

        def positions(arr):
            with obs.span("cam.profile.upload"):
                return obs.to_device(np.asarray(arr, np.int64), dev)

        def grid_counts(w: Workload):
            if w.kind == POINT:
                d_radius = page_ref.lut_radius(max(c.eps for c in cands),
                                               geom.c_ipp)
                pos = positions(w.positions)
                with obs.span("cam.profile.histogram"):
                    counts, totals = page_ref.point_page_refs_grid(
                        pos, eps_arr, d_radius, geom.c_ipp, num_pages)
                dac_mass = dac_per_query * w.n_queries
                return counts, _np64(totals), dac_mass
            if w.kind in WRITE_KINDS:
                # locate references vary with eps (same banded kernel as
                # point); the dirtied target window is eps-independent, so
                # ONE shared write stream serves the whole grid (amp = 1:
                # un-built uniform-eps candidates have no gap structure).
                d_radius = page_ref.lut_radius(max(c.eps for c in cands),
                                               geom.c_ipp)
                pos = positions(w.positions)
                with obs.span("cam.profile.histogram"):
                    counts, totals = page_ref.point_page_refs_grid(
                        pos, eps_arr, d_radius, geom.c_ipp, num_pages)
                    wcounts, wtotal = page_ref.point_page_refs(
                        pos, 0, geom.c_ipp, num_pages)
                write_parts.append(WriteStreamPart(
                    wcounts, float(obs.to_host(wtotal))))
                dac_mass = (dac_per_query + 1.0) * w.n_queries
                return counts, _np64(totals), dac_mass
            if w.kind == RANGE:
                lo, hi = positions(w.positions), positions(w.hi_positions)
                with obs.span("cam.profile.histogram"):
                    counts, totals = page_ref.range_page_refs_grid(
                        lo, hi, eps_arr, geom.c_ipp, num_pages, int(wl.n))
                totals = _np64(totals)
                return counts, totals, totals.copy()
            if w.kind == SORTED:
                sp = sorted_part_for(w, 0, geom, num_pages, dev)
                sorted_parts.append(sp)
                return (torch.zeros((len(cands), num_pages),
                                    dtype=torch.float32, device=dev),
                        np.zeros(len(cands)),
                        np.full(len(cands), sp.total_refs))
            if w.kind == MIXED:
                counts = torch.zeros((len(cands), num_pages),
                                     dtype=torch.float32, device=dev)
                totals = np.zeros(len(cands))
                dac_mass = np.zeros(len(cands))
                for part in w.parts:
                    c, t, d = grid_counts(part)
                    counts, totals, dac_mass = counts + c, totals + t, dac_mass + d
                return counts, totals, dac_mass
            raise UnsupportedWorkloadError(
                wl.kind, part=w.kind if w is not wl else None)

        counts, totals, dac_mass = grid_counts(wl)
        dacs = dac_mass / max(wl.n_queries, 1)
        spart = (_merge_sorted_parts(sorted_parts) if sorted_parts else None)
        wpart = (_merge_write_parts(write_parts) if write_parts else None)
        return list(counts), list(totals), list(dacs), spart, wpart

    def _finish(self, prof: PageRefProfile, wl: Workload, cap: int,
                t0: float) -> CamEstimate:
        """Compose a profile with the cache model — Eq. 3 (legacy-identical).

        Sorted streams (pure, or the sorted sub-part of a mixed workload)
        dispatch by ``system.policy`` through the shared
        ``cache_models.sorted_scan`` family: the Theorem III.1 compulsory
        closed form under recency eviction, the frequency-aware form under
        LFU-like policies, the thrash regime below the capacity premise.
        """
        if prof.sorted_stream:
            sp = prof.sorted_part or SortedScanPart(
                prof.total_refs, float(prof.distinct_pages),
                prof.min_capacity)
            h = cache_models.sorted_scan_hit_rate(
                self.system.policy, cap, total_refs=sp.total_refs,
                distinct_pages=sp.distinct_pages, coverage=sp.coverage,
                pinned_retouches=sp.pinned_retouches,
                min_capacity=sp.min_capacity)
            io = (1.0 - h) * prof.expected_dac
            return CamEstimate(io, h, prof.expected_dac, cap,
                               sp.total_refs, sp.distinct_pages,
                               time.perf_counter() - t0,
                               self._sorted_label(cap, sp),
                               device_cost=self._device_cost(io))
        wp = prof.write_part
        counts = prof.counts
        sample_refs = prof.total_refs
        if wp is not None:
            # combined read+write request histogram — same pre-combine the
            # batched solve (hit_rate_grid's write_* path) applies
            counts = counts + wp.counts
            sample_refs = sample_refs + wp.total_refs
        full_refs = sample_refs * wl.scale
        n_distinct = (float(prof.distinct_pages)
                      if prof.distinct_pages is not None
                      else float(torch.sum(counts > 0)))
        if cap <= 0 or sample_refs <= 0:
            h = (0.0 if wp is None or sample_refs <= 0
                 else -wp.total_refs / sample_refs)
        else:
            probs = counts / max(float(np.float32(sample_refs)), 1e-30)
            h = float(cache_models.hit_rate(
                self.system.policy, cap, probs, total_requests=full_refs,
                distinct_pages=n_distinct))
            if wp is not None:
                h -= float(cache_models.writeback_fraction(
                    self.system.policy, probs,
                    wp.counts / max(float(np.float32(sample_refs)), 1e-30),
                    cap, n_distinct))
        sp = prof.sorted_part
        if sp is not None:
            # Mixed workload with sorted sub-streams: expected misses add
            # over the shared buffer (each part priced by its own model).
            h_s = cache_models.sorted_scan_hit_rate(
                self.system.policy, cap, total_refs=sp.total_refs,
                distinct_pages=sp.distinct_pages, coverage=sp.coverage,
                pinned_retouches=sp.pinned_retouches,
                min_capacity=sp.min_capacity)
            s_full = sp.total_refs * wl.scale
            total_full = full_refs + s_full
            miss = (1.0 - h) * full_refs + (1.0 - h_s) * s_full
            h = (1.0 - miss / max(total_full, 1.0)
                 if total_full > 0 else 0.0)
            full_refs = total_full
            n_distinct = (float(torch.sum((prof.counts > 0)
                                          | (sp.coverage > 0)))
                          if sp.coverage is not None
                          # coverage-less legacy part: no union available,
                          # report the parts' sum
                          else n_distinct + sp.distinct_pages)
        io = (1.0 - h) * float(prof.expected_dac)
        return CamEstimate(
            io_per_query=io, hit_rate=h, dac=float(prof.expected_dac),
            capacity_pages=cap, total_refs=float(full_refs),
            distinct_pages=n_distinct,
            estimation_seconds=time.perf_counter() - t0,
            policy=self.system.policy, device_cost=self._device_cost(io))

    def _device_cost(self, io_per_query: float) -> Optional[float]:
        """Compose with the device model (§III-A): one run per query."""
        if self.system.device is None:
            return None
        return float(self.system.device.cost(np.asarray([io_per_query])))

    def _sampled(self, workload: Workload, rate: float, seed: int) -> Workload:
        if rate >= 1.0:
            return workload
        # Keyed by identity (the workload object is the unit of reuse in a
        # tuning loop); the strong reference in the value keeps the id valid
        # for the entry's lifetime.  FIFO-bounded so a long-lived session
        # over many workloads cannot pin arbitrary amounts of array memory.
        key = (id(workload), rate, seed)
        hit = self._sample_cache.get(key)
        if hit is not None:
            return hit[1]
        sampled = workload.sample(rate, seed)
        while len(self._sample_cache) >= self._SAMPLE_CACHE_MAX:
            self._sample_cache.pop(next(iter(self._sample_cache)))
        self._sample_cache[key] = (workload, sampled)
        return sampled
