"""JoinSession — plan-based join API on the CostSession nouns (paper §VI).

The paper frames the hybrid join as "the same modeling principle" applied to
joins; this module makes that literal.  A :class:`JoinSession` binds the two
session nouns the estimation side already uses — an
:class:`~repro_torch.core.session.IndexModel` for the inner relation and a
:class:`~repro_torch.core.session.System` for where it runs — and splits the
join into the classic planner/executor pair:

* ``plan(outer, strategy)``   -> :class:`JoinPlan`: typed segments plus a
  model-predicted :class:`~repro_torch.core.session.PlanCost`.  The four
  classic strategies (INLJ / point-only / range-only / hybrid) are all just
  plans — the pure strategies are single-segment degenerate cases of the
  hybrid partitioning.
* ``execute(plan)``           -> :class:`JoinStats`: ONE execution path
  replays any plan through the simulated buffered disk.
* ``choose(outer)``           -> :class:`ChooseResult`: CAM-predicted costs
  for every strategy, with the cheapest plan selected *up front* — the
  model drives the plan, it doesn't just report on it afterwards.

Cost predictions compose Eq. 17's fitted coefficients with CAM's cache-aware
miss estimates rather than charging the fitted constants blindly:

* sorted streams price point probing through the shared policy-aware
  sorted-scan model (``cache_models.sorted_scan_misses`` — the same model
  behind ``CostSession``'s sorted branch): one compulsory miss per distinct
  page under recency eviction (Theorem III.1), the frequency-aware closed
  form under LFU-like policies, and the thrash regime when the buffer
  cannot hold a probe window (every logical reference misses);
* the unsorted INLJ stream is priced through the full CostSession IRM
  hit-rate machinery (Algorithm 1) on the outer point workload.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import cache_models, page_ref
from repro_torch.core.session import (DEFAULT_TORCH_DEVICE, CostSession,
                                      GridProfiles, PlanCost, SortedScanPart,
                                      System)
from repro_torch.core.workload import Workload, locate
from repro_torch.engine import PriceTable
from repro_torch.index.adapters import wrap_index
from repro_torch.join.calibrate import calibrate_system
from repro_torch.join.hybrid import (JoinCostParams, Segment,
                                     partition_probes, segment_costs)
from repro_torch.sim.machine import BufferedDisk, MachineParams

__all__ = ["JoinPlan", "JoinStats", "ChooseResult", "JoinCostCurve",
           "JoinSession", "STRATEGIES"]

STRATEGIES = ("inlj", "point-only", "range-only", "hybrid")


@dataclasses.dataclass
class JoinStats:
    """Replayed (ground-truth) execution outcome of one plan."""

    strategy: str
    seconds: float          # simulated end-to-end time
    physical_ios: int
    logical_refs: int
    matches: int
    n_segments: int = 1
    n_range_segments: int = 0
    wall_seconds: float = 0.0


@dataclasses.dataclass(frozen=True)
class JoinPlan:
    """An executable join plan: probe order, page windows, typed segments.

    ``segments`` reuse the Algorithm 2 :class:`Segment` type; pure strategies
    carry exactly one.  ``cost`` is the model prediction this plan was ranked
    by; ``thrash`` records whether the buffer was below the Theorem III.1
    capacity premise when the point-miss terms were priced.
    """

    strategy: str
    outer_keys: np.ndarray            # in probe order (sorted unless inlj)
    page_lo: np.ndarray
    page_hi: np.ndarray
    segments: Tuple[Segment, ...]
    sorted_stream: bool
    cost: PlanCost
    params: JoinCostParams
    capacity: int
    thrash: bool = False

    @property
    def n_range_segments(self) -> int:
        return sum(1 for s in self.segments if s.use_range)


@dataclasses.dataclass(frozen=True)
class JoinCostCurve:
    """Per-strategy predicted cost as a FUNCTION of buffer capacity.

    ``plan`` collapses the model to one scalar at one capacity;
    budget-split solvers (:class:`repro_torch.join.tree.JoinTreeSession`)
    need the whole curve so they can trade capacity between competing
    levels.  All K capacities of one outer stream are priced by ONE
    :class:`repro_torch.engine.PricingEngine` solve over a two-row
    :class:`repro_torch.engine.PriceTable` (the sorted point-probe stream and
    the unsorted INLJ stream, each at every capacity) — never a per-capacity
    Python loop or replay.

    ``seconds[s][k]`` / ``physical_ios[s][k]`` is strategy ``s`` priced at
    ``capacities[k]`` buffer pages.  Curves are non-increasing in capacity
    (more buffer never costs more under the model — the budget-split
    monotonicity tests pin this).
    """

    capacities: np.ndarray                    # (K,) buffer pages
    seconds: Dict[str, np.ndarray]            # strategy -> (K,)
    physical_ios: Dict[str, np.ndarray]       # strategy -> (K,)
    n_probes: int

    def best_at(self, k: int, objective: str = "seconds") -> Tuple[str, float]:
        """(strategy, cost) minimizing ``objective`` at capacity index k."""
        table = self.seconds if objective == "seconds" else self.physical_ios
        s = min(table, key=lambda name: table[name][k])
        return s, float(table[s][k])


@dataclasses.dataclass(frozen=True)
class ChooseResult:
    """Outcome of model-guided strategy selection.

    All candidate plans are retained — executing a non-chosen strategy for
    comparison reuses the plan built during selection instead of re-planning.
    """

    plan: JoinPlan
    costs: Dict[str, PlanCost]        # every strategy's predicted cost
    plans: Dict[str, JoinPlan] = dataclasses.field(default_factory=dict)

    @property
    def strategy(self) -> str:
        return self.plan.strategy


@dataclasses.dataclass(frozen=True)
class _CurveState:
    """Capacity-independent statistics of ONE outer stream — the profiling
    half of :meth:`JoinSession.cost_curve`, split from the pricing half so a
    join tree can batch every level's streams into ONE engine solve."""

    n: int                                 # probe count
    refs: float                            # total window page references
    span: int                              # coalesced range-scan span (pages)
    min_cap: int                           # Thm III.1 capacity premise
    sorted_part: SortedScanPart            # (R, N, coverage, pinned)
    num_pages: int                         # inner relation's page count
    page_lo: np.ndarray                    # sorted probe windows (for the
    page_hi: np.ndarray                    # hybrid partitioning)
    inlj_prof: Optional[object] = None     # PageRefProfile, unsorted stream
    inlj_scale: float = 1.0                # CAM-x full/sample ratio

    @property
    def r(self) -> float:
        return self.sorted_part.total_refs

    @property
    def nd(self) -> float:
        return self.sorted_part.distinct_pages


def curve_price_table(states, caps: np.ndarray,
                      device=DEFAULT_TORCH_DEVICE) -> PriceTable:
    """ONE PriceTable covering every stream's sorted + INLJ curve cells.

    Each ``(label, state)`` contributes up to two GridProfiles rows, each
    priced at every capacity in ``caps``:

    * ``(label, "sorted")`` — a pure sorted-scan row (empty IRM histogram
      plus the stream's :class:`SortedScanPart`): the composed
      ``hit_rate_grid`` collapses to the policy-aware sorted-scan model, so
      ``(1 - h) * R`` IS the old ``sorted_scan_miss_curve``.
    * ``(label, "inlj")`` — the unsorted stream's IRM histogram.  CAM-x
      scales are baked in per row: counts AND totals are both multiplied by
      the row's own scale, which leaves the IRM probabilities unchanged
      while the full-volume request mass comes out right under the shared
      ``scale=1.0`` profile — levels sampled at different rates can still
      share one GridProfiles (and therefore one engine call).

    Every histogram row is built on ``device`` (the pricing session's torch
    device), and profile tensors that live elsewhere are moved there, so a
    table never mixes CPU and CUDA rows.
    """
    width = max(st.num_pages for _, st in states)

    def pad(arr):
        arr = torch.as_tensor(arr, dtype=torch.float32, device=device)
        w = int(arr.shape[-1])
        return arr if w == width else F.pad(arr, (0, width - w))

    knobs, counts, totals, dacs, sparts, cells = [], [], [], [], [], []
    for label, st in states:
        sp = st.sorted_part
        if sp.coverage is not None:
            sp = dataclasses.replace(sp, coverage=pad(sp.coverage))
        knobs.append((label, "sorted"))
        counts.append(torch.zeros((width,), dtype=torch.float32,
                                  device=device))
        totals.append(0.0)
        dacs.append(st.r / max(st.n, 1))
        sparts.append(sp)
        cells.append((knobs[-1], len(knobs) - 1, caps))
        if st.inlj_prof is not None:
            s = np.float32(st.inlj_scale)
            knobs.append((label, "inlj"))
            counts.append(pad(st.inlj_prof.counts) * float(s))
            totals.append(float(st.inlj_prof.total_refs) * float(s))
            dacs.append(float(st.inlj_prof.expected_dac))
            sparts.append(None)
            cells.append((knobs[-1], len(knobs) - 1, caps))
    k = len(knobs)
    profiles = GridProfiles(
        knobs=tuple(knobs), counts=torch.stack(counts),
        totals=np.asarray(totals, np.float64),
        dacs=np.asarray(dacs, np.float64), sizes=np.zeros(k, np.float64),
        caps=np.full(k, int(np.max(caps)), np.int64), sparts=tuple(sparts),
        skipped=(), scale=1.0, n_queries=sum(st.n for _, st in states))
    return PriceTable.from_cells(profiles, cells)


def _stream_curves(sol, label, st: _CurveState,
                   caps: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Read one stream's (sorted miss curve, INLJ I/O curve) back out of
    the engine solution by its span keys."""
    a, b = sol.table.spans[(label, "sorted")]
    miss_curve = (1.0 - sol.hit_rates[a:b]) * st.r
    if st.inlj_prof is None:
        # No key file to locate against: every probe window priced cold
        # (upper bound, biased against INLJ — as _inlj_misses).
        io_inlj = np.full(caps.shape, st.refs)
    else:
        a, b = sol.table.spans[(label, "inlj")]
        io_inlj = ((1.0 - sol.hit_rates[a:b])
                   * st.inlj_prof.expected_dac * st.n)
    return miss_curve, io_inlj


def _union_size(page_lo: np.ndarray, page_hi: np.ndarray) -> int:
    """|union of inclusive page intervals| — exact for any order (sorts by
    lo, then the running-frontier sweep of Theorem III.1)."""
    if page_lo.shape[0] == 0:
        return 0
    order = np.argsort(page_lo, kind="stable")
    lo, hi = page_lo[order], page_hi[order]
    cm = np.maximum.accumulate(hi)
    prev = np.concatenate([[lo[0] - 1], cm[:-1]])
    return int(np.maximum(0, hi - np.maximum(lo, prev + 1) + 1).sum())


def _count_matches(inner_keys: np.ndarray, outer_keys: np.ndarray) -> int:
    pos = np.searchsorted(inner_keys, outer_keys)
    pos = np.minimum(pos, inner_keys.shape[0] - 1)
    return int((inner_keys[pos] == outer_keys).sum())


class JoinSession:
    """Join planner/executor bound to (inner IndexModel, System).

    ``inner`` may be a raw index (PGM / RMI / RadixSpline) or an adapter;
    it is normalized through :func:`repro_torch.index.adapters.wrap_index`.
    ``inner_keys`` (the sorted key file) enables match counting and the
    INLJ CostSession estimate; planning and execution of sorted strategies
    work without it.
    """

    def __init__(self, inner, system: System,
                 inner_keys: Optional[np.ndarray] = None,
                 machine: MachineParams = MachineParams(),
                 params: Optional[JoinCostParams] = None):
        self.inner = wrap_index(inner)
        self.system = system
        self.inner_keys = None if inner_keys is None else np.asarray(inner_keys)
        self.machine = machine
        self.layout = system.layout()
        self.capacity = max(1, system.capacity_for(self.inner.size_bytes))
        self.num_pages = self.layout.num_pages(self.inner.n)
        self._params = params
        self._cost_session = CostSession(system)
        self._capped_sessions: Dict[int, CostSession] = {}

    # ------------------------------------------------------------ calibration
    @property
    def params(self) -> JoinCostParams:
        """Eq. 17 coefficients; lazily calibrated against the machine."""
        if self._params is None:
            if self.inner_keys is None:
                self._params = JoinCostParams()
            else:
                self._params = self.calibrate()
        return self._params

    def calibrate(self, seed: int = 0) -> JoinCostParams:
        """Fit Eq. 17 against the simulated machine (join/calibrate.py)."""
        self._params = calibrate_system(self.inner, self.inner_keys,
                                        self.system, machine=self.machine,
                                        seed=seed)
        return self._params

    # --------------------------------------------------------------- planning
    def plan(self, outer: Union[np.ndarray, Workload], strategy: str = "hybrid",
             n_min: int = 1024, k_max: int = 8192, gamma: float = 0.05,
             params: Optional[JoinCostParams] = None,
             sample_rate: float = 1.0,
             capacity: Optional[int] = None) -> JoinPlan:
        """Build a typed plan with model-predicted per-segment costs.

        ``capacity`` caps the buffer externally (in pages): a join tree
        sharing one pool across levels plans each level at its allotted
        slice instead of the session default (the System's full leftover
        budget).  The capacity is baked into the plan and honoured by
        ``execute``.
        """
        if strategy not in STRATEGIES:
            raise ValueError(f"unknown strategy {strategy!r}; expected one "
                             f"of {STRATEGIES}")
        cap = self.capacity if capacity is None else max(1, int(capacity))
        outer_keys = self._outer_keys(outer)
        p = params or self.params
        sorted_stream = strategy != "inlj"
        probe = np.sort(outer_keys) if sorted_stream else outer_keys
        plo, phi = self.inner.probe_windows(probe, self.system.geom)
        # Thrash regime = the buffer cannot hold a *typical* probe window
        # (99th-percentile width, so one badly-predicted outlier window —
        # e.g. a single poor RMI leaf — does not flip the whole plan onto
        # worst-case pricing).
        widths = phi - plo + 1
        typical_w = int(np.quantile(widths, 0.99)) if widths.size else 0
        thrash = cap < typical_w + 1
        n = probe.shape[0]
        refs = int(widths.sum())
        miss_scale = (1.0 if thrash or not sorted_stream
                      else self._policy_miss_scale(plo, phi, cap))

        if strategy == "hybrid":
            # Bias Algorithm 2's point/range decisions by the same policy
            # correction the prediction uses.
            p_eff = (p if miss_scale == 1.0 else dataclasses.replace(
                p, lambda_point=p.lambda_point * miss_scale))
            segments = tuple(partition_probes(plo, phi, p_eff, n_min=n_min,
                                              k_max=k_max, gamma=gamma,
                                              thrash=thrash))
        else:
            distinct = _union_size(plo, phi)
            span = (int(phi.max()) - int(plo.min()) + 1) if n else 0
            miss = refs if thrash else distinct
            cost_p, cost_r = segment_costs(n, miss, span, p)
            segments = (Segment(0, n, int(plo.min()) if n else 0,
                                int(phi.max()) if n else 0, n, distinct,
                                strategy == "range-only", cost_p, cost_r,
                                refs),)

        cost = self._predict(strategy, segments, probe, p, thrash, sample_rate,
                             miss_scale, cap)
        return JoinPlan(strategy, probe, plo, phi, segments, sorted_stream,
                        cost, p, cap, thrash)

    def choose(self, outer: Union[np.ndarray, Workload],
               n_min: int = 1024, k_max: int = 8192, gamma: float = 0.05,
               params: Optional[JoinCostParams] = None,
               sample_rate: float = 1.0,
               capacity: Optional[int] = None) -> ChooseResult:
        """CAM-predicted plan selection: price all strategies, pick cheapest.

        This replaces "run all four and compare" — the model selects the
        strategy up front; tests validate the pick against exhaustive
        replay (§VII-D).  ``sample_rate`` prices the INLJ hit-rate estimate
        from a CAM-x workload sample; ``capacity`` externally caps the
        buffer as in :meth:`plan`.
        """
        plans = {s: self.plan(outer, s, n_min=n_min, k_max=k_max, gamma=gamma,
                              params=params, sample_rate=sample_rate,
                              capacity=capacity)
                 for s in STRATEGIES}
        costs = {s: pl.cost for s, pl in plans.items()}
        best = min(costs, key=lambda s: costs[s].seconds)
        return ChooseResult(plans[best], costs, plans)

    def cost_curve(self, outer: Union[np.ndarray, Workload],
                   capacities, n_min: int = 1024, k_max: int = 8192,
                   gamma: float = 0.05,
                   params: Optional[JoinCostParams] = None,
                   sample_rate: float = 1.0) -> JoinCostCurve:
        """Predicted cost of every strategy across a capacity vector.

        The curve form of :meth:`plan`'s scalar prediction, for budget-split
        solvers: all K capacities of both model streams — the policy-aware
        sorted point-probe stream (shared by point-only and the hybrid's
        point segments) and the unsorted INLJ stream — price through ONE
        ``engine.price`` call over a :func:`curve_price_table`, with no
        per-capacity Python loop or replay.

        Capacity enters the hybrid's *partitioning* only through the thrash
        flag and the LFU miss scale, so the curve partitions once at the
        largest grid capacity and re-prices the fixed segments along the
        miss curve; the final plan built at the chosen capacity
        re-partitions exactly (``plan(..., capacity=...)``), so the
        approximation only affects which split the solver prefers, not the
        cost of the plan it returns.
        """
        caps = np.atleast_1d(np.asarray(capacities, np.int64))
        if caps.size == 0 or (caps < 1).any():
            raise ValueError("capacities must be >= 1 buffer page")
        p = params or self.params
        st = self._curve_state(outer, sample_rate)
        sol = self._cost_session.engine.price(
            curve_price_table([("outer", st)], caps,
                              device=self._cost_session.device))
        miss_curve, io_inlj = _stream_curves(sol, "outer", st, caps)
        return self._curve_from_solution(st, caps, miss_curve, io_inlj,
                                         n_min, k_max, gamma, p)

    def _curve_state(self, outer: Union[np.ndarray, Workload],
                     sample_rate: float = 1.0) -> _CurveState:
        """Profile the outer stream once, independent of capacity: sorted
        probe-window statistics plus the unsorted stream's IRM profile."""
        outer_keys = self._outer_keys(outer)
        probe = np.sort(outer_keys)
        plo, phi = self.inner.probe_windows(probe, self.system.geom)
        widths = phi - plo + 1
        n = probe.shape[0]
        typical_w = int(np.quantile(widths, 0.99)) if widths.size else 0
        r, nd, coverage, pinned = page_ref.sorted_workload_stats(
            *self._windows(plo, phi), self.num_pages)
        spart = SortedScanPart(float(r), float(nd), typical_w + 1,
                               coverage, float(pinned))
        prof, scale = None, 1.0
        if self.inner_keys is not None:
            wl = Workload.point(locate(self.inner_keys, outer_keys),
                                n=self.inner.n, query_keys=outer_keys)
            if sample_rate < 1.0:
                wl = wl.sample(sample_rate)
            prof = self.inner.page_ref_profile(
                wl, self.system.geom, device=self._cost_session.device)
            scale = float(wl.scale)
        return _CurveState(
            n=n, refs=float(widths.sum()),
            span=(int(phi.max()) - int(plo.min()) + 1) if n else 0,
            min_cap=typical_w + 1, sorted_part=spart,
            num_pages=self.num_pages, page_lo=plo, page_hi=phi,
            inlj_prof=prof, inlj_scale=scale)

    def _curve_from_solution(self, st: _CurveState, caps: np.ndarray,
                             miss_curve: np.ndarray, io_inlj: np.ndarray,
                             n_min: int, k_max: int, gamma: float,
                             p: JoinCostParams) -> JoinCostCurve:
        """Assemble the four strategy curves from the solved miss curves —
        pure Eq. 17 arithmetic, every model solve already behind the
        engine call that produced ``miss_curve`` / ``io_inlj``."""
        n, r, nd = st.n, st.r, st.nd
        seconds: Dict[str, np.ndarray] = {}
        ios: Dict[str, np.ndarray] = {}
        sort_s = n * p.sort_per_key

        # point-only: one segment over the whole sorted stream.
        seconds["point-only"] = (sort_s + p.delta + p.alpha * n
                                 + p.lambda_point * miss_curve)
        ios["point-only"] = miss_curve.copy()

        # range-only: one coalesced scan — capacity-independent.
        sec_r = (sort_s + p.eta + (p.beta + p.lambda_range) * st.span
                 + 0.25 * p.alpha * n)
        seconds["range-only"] = np.full(caps.shape, sec_r)
        ios["range-only"] = np.full(caps.shape, float(st.span))

        # inlj: IRM hit-rate curve of the unsorted stream.
        seconds["inlj"] = p.delta + p.alpha * n + p.lambda_point * io_inlj
        ios["inlj"] = io_inlj

        # hybrid: fixed segments from the largest-capacity partitioning,
        # point segments re-priced along the sorted miss curve.  The
        # reference policy scale is read off the miss curve already in
        # hand (miss/N at the largest capacity — the same ratio
        # _policy_miss_scale would solve for), not re-solved.
        k_ref = int(np.argmax(caps))
        ref_cap = int(caps[k_ref])
        scale_ref = (1.0 if ref_cap < st.min_cap
                     else max(1.0, float(miss_curve[k_ref]) / max(nd, 1.0)))
        p_eff = (p if scale_ref == 1.0 else dataclasses.replace(
            p, lambda_point=p.lambda_point * scale_ref))
        segments = partition_probes(st.page_lo, st.page_hi, p_eff,
                                    n_min=n_min, k_max=k_max, gamma=gamma,
                                    thrash=ref_cap < st.min_cap)
        pt = [s for s in segments if not s.use_range]
        rg = [s for s in segments if s.use_range]
        d_pt = float(sum(s.distinct_pages for s in pt))
        r_pt = float(sum(s.total_refs for s in pt))
        n_pt = float(sum(s.n_keys for s in pt))
        # per-capacity miss of the point segments: the whole-stream policy
        # scale applied to their distinct mass, clamped by their refs, with
        # the thrash regime charged in full below the premise.
        scale_curve = np.where(miss_curve >= float(r),
                               np.inf,  # thrash: every reference misses
                               miss_curve / max(nd, 1.0))
        miss_pt = np.minimum(np.maximum(d_pt * scale_curve, d_pt), r_pt) \
            if pt else np.zeros(caps.shape)
        sec_hy = np.full(caps.shape, sort_s)
        for s in rg:
            sp = s.page_hi - s.page_lo + 1
            sec_hy += (p.eta + (p.beta + p.lambda_range) * sp
                       + 0.25 * p.alpha * s.n_keys)
        sec_hy += len(pt) * p.delta + p.alpha * n_pt \
            + p.lambda_point * miss_pt
        io_hy = miss_pt + float(sum(s.page_hi - s.page_lo + 1 for s in rg))
        seconds["hybrid"] = sec_hy
        ios["hybrid"] = io_hy

        return JoinCostCurve(caps, seconds, ios, n)

    # -------------------------------------------------------------- execution
    def execute(self, plan: JoinPlan) -> JoinStats:
        """Replay ANY plan through the buffered disk — the single execution
        path that subsumes the four legacy executors.

        The buffer is sized from ``plan.capacity`` (the capacity the plan
        was priced at — the session default unless the plan came from an
        externally-capped budget, e.g. a join-tree slice)."""
        t0 = time.perf_counter()
        m = self.machine
        disk = BufferedDisk(self.num_pages, plan.capacity, self.system.policy)
        plo, phi = plan.page_lo, plan.page_hi
        seconds = plan.outer_keys.shape[0] * m.sort_per_key \
            if plan.sorted_stream else 0.0
        n_range = 0
        for seg in plan.segments:
            if seg.use_range:
                n_range += 1
                misses = disk.fetch_window(seg.page_lo, seg.page_hi)
                span = seg.page_hi - seg.page_lo + 1
                seconds += (m.range_op_setup + span * m.cpu_per_page_scan
                            + misses * m.miss_latency_range
                            + seg.n_keys * m.cpu_per_key * 0.25)
            else:
                for a, b in zip(plo[seg.start:seg.end], phi[seg.start:seg.end]):
                    misses = disk.fetch_window(int(a), int(b))
                    seconds += (m.cpu_per_key + m.point_op_setup
                                + misses * m.miss_latency_point)
        matches = (_count_matches(self.inner_keys, plan.outer_keys)
                   if self.inner_keys is not None else 0)
        return JoinStats(plan.strategy, seconds, disk.physical_reads,
                         disk.logical_reads, matches,
                         n_segments=len(plan.segments),
                         n_range_segments=n_range,
                         wall_seconds=time.perf_counter() - t0)

    def run(self, outer: Union[np.ndarray, Workload],
            strategy: Optional[str] = None, **plan_kwargs) -> JoinStats:
        """plan (or choose, when ``strategy`` is None) + execute."""
        if strategy is None:
            return self.execute(self.choose(outer, **plan_kwargs).plan)
        return self.execute(self.plan(outer, strategy, **plan_kwargs))

    # -------------------------------------------------------------- internals
    def _outer_keys(self, outer: Union[np.ndarray, Workload]) -> np.ndarray:
        if isinstance(outer, Workload):
            if outer.parts:        # mixed read-blend: concatenate the parts
                return np.concatenate(
                    [self._outer_keys(p) for p in outer.parts])
            if outer.query_keys is None:
                raise ValueError("outer Workload needs query_keys (the join "
                                 "probes the inner index with them)")
            return np.asarray(outer.query_keys)
        return np.asarray(outer)

    def _predict(self, strategy: str, segments: Tuple[Segment, ...],
                 probe: np.ndarray, p: JoinCostParams, thrash: bool,
                 sample_rate: float = 1.0, miss_scale: float = 1.0,
                 capacity: Optional[int] = None) -> PlanCost:
        """Eq. 17 composed with CAM miss estimates, per strategy."""
        n = probe.shape[0]
        refs = float(sum(s.total_refs for s in segments))
        if strategy == "inlj":
            io = self._inlj_misses(probe, sample_rate, capacity)
            seconds = p.delta + p.alpha * n + p.lambda_point * io
            return PlanCost(strategy, seconds, io, refs)
        seconds = n * p.sort_per_key
        io = 0.0
        for s in segments:
            if s.use_range:
                span = s.page_hi - s.page_lo + 1
                io += span
                seconds += (p.eta + (p.beta + p.lambda_range) * span
                            + 0.25 * p.alpha * s.n_keys)   # result extraction
            else:
                miss = (s.total_refs if thrash
                        else min(s.distinct_pages * miss_scale, s.total_refs))
                io += miss
                seconds += p.delta + p.alpha * s.n_keys + p.lambda_point * miss
        return PlanCost(strategy, seconds, io, refs)

    def _policy_miss_scale(self, plo: np.ndarray, phi: np.ndarray,
                           capacity: Optional[int] = None) -> float:
        """Policy correction for sorted streams (point probing).

        Theorem III.1's one-compulsory-miss-per-distinct-page closed form
        relies on recency-based eviction keeping the sliding probe window
        resident; frequency-based LFU evicts the advancing frontier (and
        resets its count) so it misses more.  The segment miss terms are
        scaled by the ratio of the shared sorted-scan model's policy-aware
        miss count (``cache_models.sorted_scan_misses`` on the
        window-coverage histogram) to the compulsory count — the SAME model
        ``CostSession._finish`` applies to sorted workloads, so planner and
        estimator can no longer disagree on one stream.
        """
        cap = self.capacity if capacity is None else capacity
        if self.system.policy in cache_models.RECENCY_POLICIES \
                or plo.shape[0] == 0:
            return 1.0
        r, nd, coverage, pinned = page_ref.sorted_workload_stats(
            *self._windows(plo, phi), self.num_pages)
        r, nd = float(r), float(nd)
        if nd == 0 or r <= 0:
            return 1.0
        miss = cache_models.sorted_scan_misses(
            self.system.policy, cap, total_refs=r,
            distinct_pages=nd, coverage=coverage,
            pinned_retouches=float(pinned))
        return max(1.0, miss / nd)

    def _windows(self, plo: np.ndarray, phi: np.ndarray):
        """Probe page windows as int64 tensors on the session's device.
        JAX (x64 off) reads the same windows as int32; page numbers stay
        far below 2**31 (781,250 pages at 200M keys), so both agree."""
        dev = self._cost_session.device
        return (torch.as_tensor(np.asarray(plo, np.int64), device=dev),
                torch.as_tensor(np.asarray(phi, np.int64), device=dev))

    def _session_at(self, capacity: Optional[int]) -> CostSession:
        """CostSession whose System view yields exactly ``capacity`` buffer
        pages for this inner index (the session default when None)."""
        if capacity is None or capacity == self.capacity:
            return self._cost_session
        cached = self._capped_sessions.get(capacity)
        if cached is None:
            view = self.system.with_budget_fraction(
                1.0, pool_bytes=capacity * self.system.geom.page_bytes,
                resident_bytes=self.inner.size_bytes)
            cached = CostSession(view)
            if len(self._capped_sessions) >= 16:
                self._capped_sessions.pop(next(iter(self._capped_sessions)))
            self._capped_sessions[capacity] = cached
        return cached

    def _inlj_misses(self, probe: np.ndarray, sample_rate: float = 1.0,
                     capacity: Optional[int] = None) -> float:
        """Expected INLJ physical I/O via the full Algorithm 1 pipeline
        (structural page refs -> IRM hit rate) on the unsorted stream."""
        if self.inner_keys is None:
            # No key file to locate against: assume every probe window is
            # cold (upper bound) — keeps planning possible, biased against
            # INLJ, which exhaustive replay tests tolerate.
            plo, phi = self.inner.probe_windows(probe, self.system.geom)
            return float((phi - plo + 1).sum())
        wl = Workload.point(locate(self.inner_keys, probe),
                            n=self.inner.n, query_keys=probe)
        est = self._session_at(capacity).estimate(self.inner, wl,
                                                  sample_rate=sample_rate)
        return est.io_per_query * probe.shape[0]
