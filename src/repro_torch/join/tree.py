"""JoinTreeSession — multi-way left-deep join trees under ONE buffer budget.

Real query plans join more than two relations; what couples the levels of a
join tree is not the probe streams (each level probes its own inner
relation's pages) but the MEMORY: every inner index is resident and the
remaining buffer pool is shared by all levels' caches.  CAM already owns
per-stream miss curves — the policy-aware sorted-scan family and the IRM
fixed points — so the pool split is a modeling problem, not a replay
problem:

* ``plan``    — derive each level's probe stream by threading match keys
  level-to-level (the locate-once discipline: key containment is a CPU
  operation on resident key files, only page fetches cost I/O), price every
  level's four strategies across the whole candidate-capacity grid through
  ONE :class:`repro_torch.engine.PricingEngine` solve (every level's sorted and
  INLJ streams at every candidate capacity batched into a single
  :func:`repro_torch.join.session.curve_price_table` — no per-level or per-split
  model call), then pick the budget split by enumerating the fraction
  simplex over the precomputed curve tables (pure array lookups).
* ``choose``  — the per-level strategy falls out of the same tables: at the
  chosen split each level takes the strategy minimizing its composed
  Eq. 17 cost at its capacity slice.
* ``execute`` — one pipelined replay path: each level's
  :class:`~repro_torch.join.session.JoinPlan` (hybrid segments materialized
  through ``partition_probes``) replays through the single
  ``JoinSession.execute`` machinery against its slice of the pool.

The per-level systems are :meth:`repro_torch.core.session.System.with_budget_fraction`
views of the ONE shared System, and the tree's predicted cost is the
:meth:`repro_torch.core.session.PlanCost.compose` sum of its level costs.
"""
from __future__ import annotations

import dataclasses
from itertools import combinations
from typing import Callable, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.session import CostSession, PlanCost, System
from repro_torch.core.workload import Workload
from repro_torch.index.adapters import wrap_index
from repro_torch.join.hybrid import JoinCostParams
from repro_torch.join.session import (STRATEGIES, JoinCostCurve, JoinPlan,
                                JoinSession, JoinStats, _stream_curves,
                                curve_price_table)
from repro_torch.sim.machine import MachineParams

__all__ = ["TreePlan", "TreeStats", "JoinTreeSession"]


@dataclasses.dataclass(frozen=True)
class TreePlan:
    """An executable multi-way plan: one budget split + one plan per level.

    ``fractions`` is the chosen split of the shared buffer pool (summing to
    1), ``capacities`` its page-count realization, ``levels`` the typed
    :class:`JoinPlan` each level replays (each carries its capacity and
    chosen strategy).  ``cost`` is the composed model prediction the split
    was ranked by; ``curves`` keeps every level's full cost curve so
    callers can inspect the trade the solver made.
    """

    fractions: Tuple[float, ...]
    capacities: Tuple[int, ...]
    levels: Tuple[JoinPlan, ...]
    cost: PlanCost
    objective: str
    curves: Tuple[JoinCostCurve, ...] = ()

    @property
    def strategies(self) -> Tuple[str, ...]:
        return tuple(pl.strategy for pl in self.levels)


@dataclasses.dataclass
class TreeStats:
    """Replayed execution outcome of a whole tree (levels summed)."""

    seconds: float
    physical_ios: int
    logical_refs: int
    matches: int                       # rows surviving the final level
    per_level: Tuple[JoinStats, ...] = ()


def _matched_keys(inner_keys: np.ndarray, probe: np.ndarray) -> np.ndarray:
    """Probe keys present in the sorted inner key file (order preserved)."""
    if probe.shape[0] == 0 or inner_keys.shape[0] == 0:
        return probe[:0]
    pos = np.searchsorted(inner_keys, probe)
    pos = np.minimum(pos, inner_keys.shape[0] - 1)
    return probe[inner_keys[pos] == probe]


class JoinTreeSession:
    """Left-deep join tree of N inner IndexModels bound to one System.

    ``inners[i]`` is the inner relation of level i (raw index or adapter,
    normalized through ``wrap_index`` by the per-level
    :class:`JoinSession`); ``inner_keys[i]`` its sorted key file — required,
    because chaining the probe stream level-to-level needs key containment
    and the INLJ estimate needs true positions.  ``probe_maps[i]`` (optional,
    default identity) maps the keys matched at level i to the probe keys of
    level i+1 — identity models a star join on one shared attribute; a
    fact-table payload lookup would supply a real mapping.

    All levels share the ONE ``system``: its memory budget holds every
    inner index plus a single buffer pool, and planning decides how the
    pool is split.
    """

    def __init__(self, inners: Sequence, system: System,
                 inner_keys: Sequence[np.ndarray],
                 machine: MachineParams = MachineParams(),
                 params: Optional[JoinCostParams] = None,
                 probe_maps: Optional[Sequence[Callable[[np.ndarray],
                                                        np.ndarray]]] = None):
        if len(inners) == 0:
            raise ValueError("join tree needs at least one inner relation")
        if len(inner_keys) != len(inners):
            raise ValueError(f"{len(inners)} inners but {len(inner_keys)} "
                             "key files; every level needs its sorted keys")
        if any(k is None for k in inner_keys):
            raise ValueError("every tree level needs inner_keys (probe "
                             "chaining and INLJ estimates locate against "
                             "them)")
        n_levels = len(inners)
        if probe_maps is None:
            probe_maps = [None] * (n_levels - 1)
        if len(probe_maps) != n_levels - 1:
            raise ValueError(f"{n_levels}-level tree needs {n_levels - 1} "
                             f"probe maps, got {len(probe_maps)}")
        self.system = system
        self.machine = machine
        self.probe_maps = tuple(probe_maps)
        page_bytes = system.geom.page_bytes

        # ONE shared pool: whatever the budget leaves after ALL inner
        # indexes are resident.  Each level's session gets a
        # with_budget_fraction view (even split as the pre-plan default;
        # plan() overrides per-level capacities with the solved split).
        wrapped = [wrap_index(inner) for inner in inners]
        index_bytes = sum(w.size_bytes for w in wrapped)
        self.pool_bytes = system.memory_budget_bytes - index_bytes
        self.pool_pages = int(self.pool_bytes // page_bytes)
        if self.pool_pages < n_levels:
            raise ValueError(
                f"memory budget {system.memory_budget_bytes:.0f} B leaves a "
                f"{max(self.pool_pages, 0)}-page pool after "
                f"{index_bytes:.0f} B of resident indexes — a {n_levels}-"
                "level tree needs at least one page per level")
        self.sessions: Tuple[JoinSession, ...] = tuple(
            JoinSession(w,
                        system.with_budget_fraction(
                            1.0 / n_levels, pool_bytes=self.pool_bytes,
                            resident_bytes=w.size_bytes),
                        inner_keys=np.asarray(keys), machine=machine,
                        params=params)
            for w, keys in zip(wrapped, inner_keys))
        # The tree's own pricing surface: plan() batches EVERY level's curve
        # cells into one PriceTable and solves them through this session's
        # engine in a single call.
        self._cost_session = CostSession(system)

    @property
    def n_levels(self) -> int:
        return len(self.sessions)

    # ------------------------------------------------------------ calibration
    def calibrate(self, seed: int = 0) -> JoinCostParams:
        """Fit Eq. 17 once (the machine constants are global) and share the
        coefficients across every level's session."""
        params = self.sessions[0].calibrate(seed=seed)
        for sess in self.sessions[1:]:
            sess._params = params
        return params

    # --------------------------------------------------------------- planning
    def probe_streams(self, outer: Union[np.ndarray, Workload]
                      ) -> Tuple[np.ndarray, ...]:
        """Per-level probe key arrays, chained by key containment.

        Level 0 probes the outer stream; level i+1 probes the keys that
        matched at level i, passed through ``probe_maps[i]``.  This is the
        join-tree analog of locate-once: containment is computed against
        the resident key files, so planning never touches the buffer.
        """
        probe = self.sessions[0]._outer_keys(outer)
        streams = []
        for i, sess in enumerate(self.sessions):
            streams.append(probe)
            if i + 1 < self.n_levels:
                matched = _matched_keys(sess.inner_keys, probe)
                fn = self.probe_maps[i]
                probe = matched if fn is None else np.asarray(fn(matched))
        return tuple(streams)

    def plan(self, outer: Union[np.ndarray, Workload], *, grid: int = 8,
             objective: str = "seconds", n_min: int = 1024,
             k_max: int = 8192, gamma: float = 0.05,
             params: Optional[JoinCostParams] = None,
             sample_rate: float = 1.0) -> TreePlan:
        """Solve (budget split, per-level strategy) as one batched grid.

        ``grid`` is the split resolution: candidate fractions are j/grid,
        and the solver enumerates every composition of ``grid`` shares into
        ``n_levels`` positive parts.  The expensive part — every level's
        four-strategy cost at every candidate capacity — prices through
        ONE engine call: each level's capacity-independent stream profile
        (:meth:`JoinSession._curve_state`) becomes two PriceTable rows, the
        whole fleet of (level x stream x capacity) cells solves as a single
        batched table, and the simplex enumeration is then pure array
        arithmetic over the resulting curves.  ``objective`` ranks splits
        by predicted ``"seconds"`` (Eq. 17) or predicted physical ``"io"``.
        """
        n_levels = self.n_levels
        if grid < n_levels:
            raise ValueError(f"grid={grid} cannot split the pool across "
                             f"{n_levels} levels (need grid >= n_levels)")
        if objective not in ("seconds", "io"):
            raise ValueError(f"objective must be 'seconds' or 'io', "
                             f"got {objective!r}")
        streams = self.probe_streams(outer)
        # Resolve Eq. 17 coefficients ONCE (level 0 lazily calibrates if
        # needed) and pass them explicitly — the machine constants are
        # global, so per-level re-calibration would be pure waste.
        params = params if params is not None else self.sessions[0].params
        # A grid finer than the pool would need sub-page shares whose
        # 1-page floor could overcommit the pool; clamp so every share is
        # at least one whole page (the constructor guarantees
        # pool_pages >= n_levels, so the clamp keeps grid >= n_levels).
        grid = min(grid, self.pool_pages)
        # Candidate capacities: j shares of grid, j = 1 .. grid-(L-1)
        # (every other level keeps at least one share).  With
        # pool_pages >= grid each share is >= 1 page and any composition's
        # capacities sum to <= pool_pages — the ONE-pool invariant.
        n_shares = grid - n_levels + 1
        shares = np.arange(1, n_shares + 1)
        caps = ((shares * self.pool_pages) // grid).astype(np.int64)

        if (caps < 1).any():
            raise ValueError("capacities must be >= 1 buffer page")
        # ONE solve for the whole tree: every level's sorted + INLJ stream
        # at every candidate capacity, batched into a single PriceTable.
        states = [sess._curve_state(streams[lvl], sample_rate)
                  for lvl, sess in enumerate(self.sessions)]
        sol = self._cost_session.engine.price(
            curve_price_table(list(enumerate(states)), caps,
                              device=self._cost_session.device))

        curves: list[JoinCostCurve] = []
        cost_tab = np.empty((n_levels, n_shares))
        strat_tab = np.empty((n_levels, n_shares), np.int64)
        for lvl, sess in enumerate(self.sessions):
            miss_curve, io_inlj = _stream_curves(sol, lvl, states[lvl], caps)
            curve = sess._curve_from_solution(
                states[lvl], caps, miss_curve, io_inlj, n_min, k_max, gamma,
                params)
            curves.append(curve)
            table = curve.seconds if objective == "seconds" \
                else curve.physical_ios
            stacked = np.stack([table[s] for s in STRATEGIES])  # (S, K)
            cost_tab[lvl] = stacked.min(axis=0)
            strat_tab[lvl] = stacked.argmin(axis=0)

        # Every composition of `grid` into n_levels positive shares, as a
        # (M, L) matrix of share counts — the split solve is a fancy-indexed
        # sum over the precomputed tables, not a per-split model call.
        if n_levels == 1:
            comps = np.array([[grid]])
        else:
            bars = np.array(list(combinations(range(1, grid), n_levels - 1)))
            edges = np.concatenate(
                [np.zeros((bars.shape[0], 1), np.int64), bars,
                 np.full((bars.shape[0], 1), grid)], axis=1)
            comps = np.diff(edges, axis=1)
        idx = comps - 1                                       # share -> column
        totals = cost_tab[np.arange(n_levels)[None, :], idx].sum(axis=1)
        best = int(np.argmin(totals))
        chosen = comps[best]

        level_plans = []
        for lvl, sess in enumerate(self.sessions):
            j = int(chosen[lvl]) - 1
            strategy = STRATEGIES[int(strat_tab[lvl, j])]
            level_plans.append(sess.plan(
                streams[lvl], strategy, n_min=n_min, k_max=k_max,
                gamma=gamma, params=params, sample_rate=sample_rate,
                capacity=int(caps[j])))
        return TreePlan(
            fractions=tuple(float(c) / grid for c in chosen),
            capacities=tuple(int(caps[c - 1]) for c in chosen),
            levels=tuple(level_plans),
            cost=PlanCost.compose("tree", [pl.cost for pl in level_plans]),
            objective=objective,
            curves=tuple(curves))

    def choose(self, outer: Union[np.ndarray, Workload],
               **plan_kwargs) -> TreePlan:
        """Alias of :meth:`plan` — for a tree, the budget split and the
        per-level strategies are ONE joint model-predicted choice."""
        return self.plan(outer, **plan_kwargs)

    # -------------------------------------------------------------- execution
    def execute(self, tree_plan: TreePlan) -> TreeStats:
        """Pipelined replay: every level's plan runs through the single
        ``JoinSession.execute`` path against its slice of the pool, and the
        surviving match keys thread into the next level (materialized at
        plan time — replay is deterministic, so the planned streams ARE the
        executed streams)."""
        if len(tree_plan.levels) != self.n_levels:
            raise ValueError(f"plan has {len(tree_plan.levels)} levels, "
                             f"session has {self.n_levels}")
        per_level = tuple(sess.execute(pl) for sess, pl
                          in zip(self.sessions, tree_plan.levels))
        return TreeStats(
            seconds=sum(st.seconds for st in per_level),
            physical_ios=sum(st.physical_ios for st in per_level),
            logical_refs=sum(st.logical_refs for st in per_level),
            matches=per_level[-1].matches,
            per_level=per_level)

    def run(self, outer: Union[np.ndarray, Workload],
            **plan_kwargs) -> TreeStats:
        """plan + execute."""
        return self.execute(self.plan(outer, **plan_kwargs))
