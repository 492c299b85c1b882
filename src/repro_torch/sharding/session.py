"""ShardingSession — fleet-wide CAM pricing and the joint shard search.

Shard boundaries are just another knob.  Where a replay-based shard
designer prices each candidate partition by re-running a trace per node,
CAM's closed forms price the entire joint space in batched solves:

1. **Route** every candidate boundary vector through the vectorized
   partition kernel (``Workload.split_at`` + local translation, see
   ``sharding/route.py``) — cheap array work, no model calls.
2. **Profile once** — ONE :meth:`CostSession.grid_profiles_grouped` pass
   builds every (boundary, shard) sub-workload's capacity-independent
   knob profiles in one concatenated :class:`GridProfiles`.
3. **Solve once** — per-shard (knob × budget-share) tables are assembled
   with :meth:`CamTuner.assemble_table` (``index_in_split=True``: a
   shard's share of the fleet pool must house its index AND its buffer)
   and concatenated, then priced by ONE :meth:`CostSession.solve_profiles`
   call — a single ``hit_rate_grid`` dispatch over every
   (boundary × shard × knob × share) cell.
4. **Argmin** — the fleet budget split is a fraction simplex: ``grid``
   units composed over shards (the JoinTreeSession buffer-split trick
   lifted from join-tree levels to fleet nodes), so the final joint
   (boundary × knob × share) choice is pure array lookups.  Zero
   per-shard model calls, structurally asserted in
   ``tests/test_torch_sharding.py``.

Per-shard knob results come out of the same code path the single-node
``TuningSession.tune_from_profiles`` runs — :meth:`CamTuner.assemble_table`
plus :meth:`CamTuner.finish_from_solution` on each shard's slice of the
one solved table — so every :class:`ShardPlan` carries a real
:class:`TuneResult`.

Skew is first-class: :meth:`ShardingSession.rebalance` compares observed
per-shard query mass (from a serving sketch summary via
``serving.sketch.shard_page_masses``, or by routing the live workload)
against the plan's, names the hot shard, re-solves with the current
boundaries among the candidates, and gates the boundary move on the PR-6
economics — switch only when horizon I/O savings repay data movement
plus per-shard index rebuild plus cold-buffer refill.
"""
from __future__ import annotations

import dataclasses
import math
import time
from itertools import combinations
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.session import CostSession, SkippedCandidate, System
from repro_torch.core.workload import Workload
from repro_torch.engine import PriceTable
from repro_torch.tuning.session import (CamTuner, IndexBuilder, SizeModel,
                                  SplitTable, TuneResult, TuningSession,
                                  _feasibility_split)

from .route import RouteStats, boundary_candidates, route
from .system import ShardedSystem

__all__ = ["ShardPlan", "FleetPlan", "RebalanceResult", "ShardingSession"]


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """One node's slice of the winning fleet configuration."""

    index: int                       # shard position in the fleet
    point: Dict[str, object]         # chosen knob point (name -> value)
    knob: object                     # the knob key (bare value / tuple)
    fraction: float                  # share of the fleet memory pool
    capacity_pages: int              # buffer pages after the index's cut
    est_io: float                    # expected physical I/Os per query
    n_queries: int                   # routed query pieces on this shard
    tune: Optional[TuneResult]       # None only for traffic-less shards


@dataclasses.dataclass(frozen=True)
class FleetPlan:
    """The solved joint (boundary × knob × budget-share) configuration."""

    boundaries: Tuple[int, ...]
    fractions: Tuple[float, ...]
    shards: Tuple[ShardPlan, ...]
    fleet_io: float                  # expected total physical I/Os
    io_per_query: float
    total_queries: int
    shard_masses: Tuple[float, ...]  # routed query-mass fraction per shard
    route_stats: RouteStats
    boundaries_searched: Tuple[Tuple[int, ...], ...]
    boundary_totals: Tuple[float, ...]   # best fleet I/O per candidate
    cells_solved: int
    skipped: Tuple[SkippedCandidate, ...]
    solve_seconds: float

    @property
    def n_shards(self) -> int:
        return len(self.shards)


@dataclasses.dataclass(frozen=True)
class RebalanceResult:
    """A priced boundary-move proposal (the TuneResult of rebalancing).

    ``switched`` is the PR-6 gate verdict: adopt ``plan`` only when the
    predicted horizon savings repay ``move_io`` (data movement + affected
    shards' index rebuild + cold-buffer refill).  ``io_current`` is the
    best the fleet can do WITHOUT moving data — current boundaries, knobs
    and budget shares re-tuned in place (those are free; only boundary
    moves ship pages).
    """

    hot_shard: int
    shard_masses: Tuple[float, ...]
    tv: float                        # TV distance vs. the plan's masses
    io_current: float                # per query, boundaries kept
    io_candidate: float              # per query, best candidate plan
    move_io: float                   # one-time cost of the boundary move
    horizon_queries: float
    predicted_savings: float         # (io_current - io_candidate) * horizon
    switched: bool
    from_boundaries: Tuple[int, ...]
    to_boundaries: Tuple[int, ...]
    plan: FleetPlan


class ShardingSession:
    """Joint (shard-boundary × per-shard knob × fleet-budget) search.

    Binds a node :class:`System` template (geometry, policy, per-node
    budget), an :class:`IndexBuilder` over the GLOBAL key file, and a
    fleet width.  The fleet memory pool defaults to ``n_shards`` node
    budgets; it is split across shards on a ``grid``-unit simplex, each
    share housing that shard's index and buffer.

    Only uniform-eps candidate families are accepted (PGM, RadixSpline):
    a pre-built global index's page windows are meaningless on a
    shard-local key file, and the uniform-eps profile kernels need no
    index at all.  Per-shard index footprints are priced with the global
    size model — conservative (a shard's index over fewer keys is no
    larger), and exact for the 1-shard fleet.
    """

    def __init__(self, node: System, builder: IndexBuilder, n_shards: int,
                 *, fleet_budget_bytes: Optional[float] = None,
                 grid: int = 8,
                 overrides: Optional[Dict[str, object]] = None,
                 size_model: Optional[SizeModel] = None):
        if n_shards < 1:
            raise ValueError("n_shards must be >= 1")
        if grid < n_shards:
            raise ValueError(f"budget grid ({grid}) needs at least one unit "
                             f"per shard ({n_shards})")
        self.node = node
        self.builder = builder
        self.n_shards = int(n_shards)
        self.grid = int(grid)
        self.n = int(len(builder.keys))
        self.fleet_budget_bytes = float(
            fleet_budget_bytes if fleet_budget_bytes is not None
            else node.memory_budget_bytes * n_shards)
        self.fleet_system = dataclasses.replace(
            node, memory_budget_bytes=self.fleet_budget_bytes)
        self.cost = CostSession(self.fleet_system)
        self.space = builder.knob_space(overrides)
        self.size_model = size_model
        # candidate fleet-pool shares, in simplex units: with S shards each
        # taking >= 1 of `grid` units, no shard can hold more than
        # grid - S + 1 units.
        self.max_share = self.grid - self.n_shards + 1
        self.splits = tuple(j / self.grid
                            for j in range(1, self.max_share + 1))

    def fleet(self, boundaries: Sequence[int] = ()) -> ShardedSystem:
        return ShardedSystem(self.node, self.n, tuple(boundaries),
                             self.fleet_budget_bytes)

    # ------------------------------------------------------------------ solve
    def solve(self, workload: Workload,
              boundary_candidates_: Optional[
                  Sequence[Sequence[int]]] = None, *,
              sample_rate: float = 1.0, seed: int = 0) -> FleetPlan:
        """One profile pass + one solve pass over the whole joint space."""
        t0 = time.perf_counter()
        if workload.n is not None and workload.n != self.n:
            raise ValueError(f"workload n={workload.n} != key file "
                             f"n={self.n}")
        if boundary_candidates_ is None:
            bcands = boundary_candidates(workload, self.n, self.n_shards)
        else:
            bcands = tuple(tuple(int(c) for c in b)
                           for b in boundary_candidates_)
        for b in bcands:
            if len(b) != self.n_shards - 1:
                raise ValueError(f"boundary candidate {b} has {len(b)} cuts; "
                                 f"a {self.n_shards}-shard fleet needs "
                                 f"{self.n_shards - 1}")
        if not bcands:
            raise ValueError("no boundary candidates")

        # ---- knob candidates, shared by every (boundary, shard) ----------
        size_model = self.size_model if self.size_model is not None \
            else self.builder.size_model()
        feasible, skipped = _feasibility_split(
            self.space.points(), self.space, size_model, self.fleet_system)
        if not feasible:
            raise ValueError("fleet budget too small for any candidate "
                             "index")
        cands = [self.builder.candidate(pt, size) for pt, size in feasible]
        for c in cands:
            if c.index is not None:
                raise ValueError(
                    "ShardingSession requires uniform-eps candidates "
                    f"({self.builder.family!r} supplied a pre-built index); "
                    "a global index's page windows are meaningless on a "
                    "shard-local key file")
        points = {self.space.key(pt): pt for pt, _size in feasible}
        min_pt, min_size = min(feasible, key=lambda fs: fs[1])

        # ---- route every boundary candidate (array work, no model) -------
        fleets = [self.fleet(b) for b in bcands]
        routed = [route(workload, f) for f in fleets]

        # ---- ONE profile pass over every busy (boundary, shard) ----------
        groups = []
        for bi, (locals_, _stats) in enumerate(routed):
            for si, wl in enumerate(locals_):
                if wl.n_queries > 0:
                    groups.append(((bi, si), cands, wl))
        profiles = self.cost.grid_profiles_grouped(groups, sample_rate, seed)
        skipped.extend(profiles.skipped)

        # ---- per-(boundary, shard) tables, concatenated ------------------
        M = self.fleet_budget_bytes
        pb = self.node.geom.page_bytes
        tables: Dict[Tuple[int, int], Tuple[SplitTable, int]] = {}
        parts, offset = [], 0
        for key, _c, _wl in groups:
            pts = {(key, kn): pt for kn, pt in points.items()}
            tab = PriceTable.from_profiles(
                profiles, pts, splits=self.splits, budget_bytes=M,
                page_bytes=pb, index_in_split=True,
                include_max_split=False)
            tables[key] = (tab, offset)
            parts.append(tab)
            offset += len(tab)
        fleet_table = PriceTable.concat(parts)

        # ---- ONE engine call prices every cell ---------------------------
        if len(fleet_table):
            sol = self.cost.engine.price(fleet_table, objective="io")
            h, n_distinct, io = sol.hit_rates, sol.distinct, sol.io
        else:
            h = n_distinct = io = np.zeros(0, np.float64)

        # ---- cost tensor: best knob per (boundary, shard, share) ---------
        B, S = len(bcands), self.n_shards
        nq = np.zeros((B, S), np.int64)
        for bi, (locals_, _stats) in enumerate(routed):
            for si, wl in enumerate(locals_):
                nq[bi, si] = wl.n_queries
        C = np.full((B, S, self.max_share), np.inf)
        for (bi, si), (tab, off) in tables.items():
            shares = np.round(tab.fracs * self.grid).astype(np.int64)
            cell_cost = nq[bi, si] * io[off:off + len(tab)]
            for t in range(len(tab)):
                j = shares[t] - 1
                if cell_cost[t] < C[bi, si, j]:
                    C[bi, si, j] = cell_cost[t]
        # traffic-less shards cost nothing wherever the smallest index fits
        for bi in range(B):
            for si in range(S):
                if (bi, si) not in tables and nq[bi, si] == 0:
                    for j, f in enumerate(self.splits):
                        if (f * M - min_size) // pb >= 1:
                            C[bi, si, j] = 0.0

        # ---- fraction-simplex argmin (the JoinTree composition trick) ----
        comps = np.asarray(
            [np.diff(np.asarray((0,) + c + (self.grid,), np.int64))
             for c in combinations(range(1, self.grid), S - 1)],
            np.int64)
        best_total, best_bi, best_comp = np.inf, -1, None
        totals_by_boundary = []
        for bi in range(B):
            totals = C[bi][np.arange(S)[None, :], comps - 1].sum(axis=1)
            k = int(np.argmin(totals))
            totals_by_boundary.append(float(totals[k]))
            if totals[k] < best_total:
                best_total, best_bi, best_comp = float(totals[k]), bi, comps[k]
        if not np.isfinite(best_total):
            raise ValueError("no feasible fleet configuration: every "
                             "(boundary, budget split) leaves some busy "
                             "shard without a fitting index")

        # ---- winner assembly: per-shard TuneResults, array lookups only --
        tsession = TuningSession(self.fleet_system, splits=self.splits)
        tuner = CamTuner()
        plans = []
        for si in range(S):
            u = int(best_comp[si])
            f = u / self.grid
            key = (best_bi, si)
            if key not in tables:
                plans.append(ShardPlan(
                    index=si, point=dict(min_pt),
                    knob=self.space.key(min_pt), fraction=f,
                    capacity_pages=int((f * M - min_size) // pb),
                    est_io=0.0, n_queries=0, tune=None))
                continue
            tab, off = tables[key]
            shares = np.round(tab.fracs * self.grid).astype(np.int64)
            sel = np.where(shares == u)[0]
            sub = tab.subset(sel)
            tune = tuner.finish_from_solution(
                tsession, self.builder, self.space, profiles, sub,
                h[off + sel], n_distinct[off + sel], objective="io",
                size_model=size_model, skipped=(), t0=t0,
                batched_solves=1)
            plans.append(ShardPlan(
                index=si, point=dict(tune.best), knob=tune.best_knob[1],
                fraction=f, capacity_pages=tune.capacity_pages,
                est_io=tune.est_io, n_queries=int(nq[best_bi, si]),
                tune=tune))

        total_q = int(nq[best_bi].sum())
        return FleetPlan(
            boundaries=bcands[best_bi],
            fractions=tuple(p.fraction for p in plans),
            shards=tuple(plans),
            fleet_io=best_total,
            io_per_query=best_total / max(total_q, 1),
            total_queries=total_q,
            shard_masses=tuple(nq[best_bi] / max(total_q, 1)),
            route_stats=routed[best_bi][1],
            boundaries_searched=bcands,
            boundary_totals=tuple(totals_by_boundary),
            cells_solved=len(fleet_table),
            skipped=tuple(skipped),
            solve_seconds=time.perf_counter() - t0)

    # -------------------------------------------------------------- rebalance
    def rebalance(self, workload: Workload, current: FleetPlan, *,
                  horizon_queries: float,
                  summary: Optional[Dict[str, np.ndarray]] = None,
                  boundary_candidates_: Optional[
                      Sequence[Sequence[int]]] = None,
                  sample_rate: float = 1.0,
                  seed: int = 0) -> RebalanceResult:
        """Detect a hot shard and price a boundary move against its cost.

        ``summary`` is a serving sketch summary (``WindowSketch.summary``);
        when given, per-shard masses come off its page-popularity
        histogram via ``shard_page_masses`` — no routing pass.  Otherwise
        ``workload`` (the observed traffic) is routed through the current
        boundaries.  The candidate plan always includes the current
        boundaries, so ``io_current`` (boundaries kept, knobs and budget
        shares re-tuned for free) is read off the same single solved
        table as the best move.
        """
        cur_b = tuple(current.boundaries)
        fleet_cur = self.fleet(cur_b)
        if summary is not None:
            from repro_torch.serving.sketch import shard_page_masses
            masses = shard_page_masses(
                summary, fleet_cur.boundary_pages,
                self.node.geom.num_pages(self.n))
        else:
            locals_, _stats = route(workload, fleet_cur)
            tot = max(1, sum(w.n_queries for w in locals_))
            masses = tuple(w.n_queries / tot for w in locals_)
        delta = np.asarray(masses) - np.asarray(current.shard_masses)
        hot = int(np.argmax(delta))
        tv = 0.5 * float(np.abs(delta).sum())

        if boundary_candidates_ is None:
            cands = list(boundary_candidates(workload, self.n,
                                             self.n_shards))
        else:
            cands = [tuple(int(c) for c in b)
                     for b in boundary_candidates_]
        if cur_b not in cands:
            cands.insert(0, cur_b)
        plan = self.solve(workload, cands, sample_rate=sample_rate,
                          seed=seed)

        total_q = max(plan.total_queries, 1)
        io_cur = plan.boundary_totals[
            plan.boundaries_searched.index(cur_b)] / total_q
        io_new = plan.io_per_query
        to_b = plan.boundaries
        if to_b == cur_b:
            move_io, savings, switched = 0.0, 0.0, False
        else:
            move_io = self._move_io(cur_b, to_b, plan)
            savings = (io_cur - io_new) * horizon_queries
            switched = savings > move_io
        return RebalanceResult(
            hot_shard=hot, shard_masses=tuple(float(m) for m in masses),
            tv=tv, io_current=float(io_cur), io_candidate=float(io_new),
            move_io=float(move_io), horizon_queries=float(horizon_queries),
            predicted_savings=float(savings), switched=switched,
            from_boundaries=cur_b, to_boundaries=to_b, plan=plan)

    def _move_io(self, old: Tuple[int, ...], new: Tuple[int, ...],
                 plan: FleetPlan) -> float:
        """One-time I/O of moving boundaries ``old`` -> ``new``.

        Moved key ranges ship as pages (read on the donor, write on the
        receiver); every shard whose edge moved also rebuilds its index
        (scan its local pages + write the index file) and refills its
        buffer cold — the PR-6 ``rebuild_io`` model applied per affected
        shard.
        """
        geom = self.node.geom
        pb = geom.page_bytes
        moved = sum(math.ceil(abs(a - b) / geom.c_ipp)
                    for a, b in zip(old, new))
        cost = 2.0 * moved
        old_edges = (0,) + old + (self.n,)
        new_edges = (0,) + new + (self.n,)
        size_model = self.size_model if self.size_model is not None \
            else self.builder.size_model()
        shards_new = self.fleet(new).shards
        for si in range(self.n_shards):
            if (old_edges[si] == new_edges[si]
                    and old_edges[si + 1] == new_edges[si + 1]):
                continue
            sp = plan.shards[si]
            size = float(size_model(**sp.point))
            distinct = 0.0
            if sp.tune is not None:
                distinct = sp.tune.estimates[sp.tune.best_knob].distinct_pages
            cost += (shards_new[si].num_pages
                     + math.ceil(size / pb)
                     + min(sp.capacity_pages, distinct))
        return float(cost)
