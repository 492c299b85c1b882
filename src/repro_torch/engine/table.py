"""The PriceTable IR and the PricingEngine behind every session's solve.

CAM's value proposition is pricing whole candidate tables — (knob x split x
capacity x policy) — without trace replay.  Before this layer, each session
re-implemented the same pipeline around ``grid_profiles``/``solve_profiles``:
table layout, row/capacity indexing, and objective argmin.  The engine names
the pieces once:

* :class:`PriceTable` — the canonical table IR: ``rows[t]`` names the
  :class:`~repro_torch.core.session.GridProfiles` row cell ``t`` prices, ``caps[t]``
  its capacity, ``fracs[t]`` the budget fraction it realizes, ``spans`` each
  knob's contiguous ``[a, b)`` cell range.  Builders cover every session's
  table shape: :meth:`from_profiles` (the tuner's joint knob x split grid,
  and — with ``index_in_split=True`` — the sharded fleet's per-shard share
  tables), :meth:`max_capacity` (plain grid estimation: one cell per knob at
  its full-budget capacity), :meth:`from_cells` (explicit capacity curves,
  the join-tree shape), :meth:`concat` (many tables solved as one), and
  :meth:`subset` (slice a solved table back out — the sharded winner
  rehydration).
* :class:`PricingEngine` — profile -> solve -> argmin behind ONE call:
  ``engine.price(table)`` returns a :class:`PriceSolution` with per-cell hit
  rates, I/O, seconds, the objective vector and its argmin.  ``calls``
  counts engine invocations, which is what the sessions' "one solve per
  search" structural tests assert against.

Two interchangeable executors do the solving:

* ``"host"`` — :class:`~repro_torch.engine.host.HostExecutor`, the golden
  reference: delegates to ``CostSession.solve_profiles`` (one batched
  ``hit_rate_grid``), bit-identical to the pre-engine sessions.
* ``"device"`` — :class:`~repro_torch.engine.device.DeviceExecutor`, the
  fused CUDA path: histograms stay on the card and the policy fixed point,
  the sorted/mixed composition and the objective argmin run in one kernel
  launch (float32-equivalent; CPU tensors take the kernel's plain torch
  version).

Dispatch rule: an explicit ``executor=`` argument wins, then the
``REPRO_ENGINE_EXECUTOR`` environment variable (``host`` / ``device``), then
the engine's constructor default, then auto — ``device`` when the session's
torch device is CUDA, ``host`` when it is the CPU.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch import obs

__all__ = ["PriceTable", "PriceSolution", "PricingEngine"]


@dataclasses.dataclass(frozen=True)
class PriceTable:
    """The assembled solve table — pure arrays, NO model calls.

    One cell per enumerated (knob, buffer-capacity) pair over one
    :class:`~repro_torch.core.session.GridProfiles`.  Tables concatenate (cells
    are independent), which is how the sharded fleet search solves every
    (boundary x shard x knob x budget-share) cell of ALL its per-shard
    tables in ONE engine call.
    """

    rows: np.ndarray
    caps: np.ndarray
    fracs: np.ndarray
    spans: Dict[object, Tuple[int, int]]
    points_of: Dict[object, Dict[str, object]]
    profiles: Optional[object] = None      # GridProfiles the rows index into
    #: Per-cell eviction-policy ids indexing ``cache_models.POLICIES``
    #: (-1 = the pricing session's configured policy).  ``None`` — the
    #: default for every builder — means every cell prices under the
    #: session policy; :meth:`cross_policies` fills the column in.
    pols: Optional[np.ndarray] = None

    def __len__(self) -> int:
        return int(self.rows.shape[0])

    # ------------------------------------------------------------- builders
    @classmethod
    def from_profiles(cls, profiles, points, *, splits, budget_bytes,
                      page_bytes, index_in_split: bool = False,
                      include_max_split: bool = True) -> "PriceTable":
        """The joint (knob x split) table — pure array assembly, NO solves.

        Default semantics (the single-node tuner): each split fraction
        ``f`` names a BUFFER slice ``floor(f * M / B)`` pages, enumerated
        per knob when it undercuts that knob's maximal feasible capacity;
        the maximal split (all memory the index does not claim) is listed
        first so objective ties resolve toward the larger buffer.

        ``index_in_split=True`` is the fleet semantics the sharded search
        uses: ``f`` is a shard's share of the FLEET budget and must house
        the shard's index AND its buffer, so the cell capacity is
        ``floor((f * M - size) / B)`` — infeasible shares (< 1 page) are
        dropped rather than clamped.  ``include_max_split=False`` skips
        the implicit maximal-split row (a fleet shard can never take the
        whole pool; its candidate shares are exactly ``splits``).
        """
        row_of = {kn: i for i, kn in enumerate(profiles.knobs)}
        rows, caps, fracs, spans = [], [], [], {}
        points_of = {}
        for knob, pt in points.items():
            if knob not in row_of:
                continue                   # profile-skipped (typed reason)
            i = row_of[knob]
            size = float(profiles.sizes[i])
            cap_max = int(profiles.caps[i])
            start = len(rows)
            if include_max_split:
                # Maximal split first: objective ties resolve to the largest
                # buffer, reproducing the legacy always-max-split tuners.
                rows.append(i)
                caps.append(cap_max)
                fracs.append((budget_bytes - size) / budget_bytes)
            for f in splits:
                if index_in_split:
                    c = int((f * budget_bytes - size) // page_bytes)
                    ok = c >= 1 and (not include_max_split or c < cap_max)
                else:
                    c = int(f * budget_bytes // page_bytes)
                    ok = 1 <= c < cap_max  # c >= cap_max: index won't fit
                if ok:
                    rows.append(i)
                    caps.append(c)
                    fracs.append(f)
            if len(rows) > start:
                spans[knob] = (start, len(rows))
                points_of[knob] = pt
        return cls(np.asarray(rows, np.int64), np.asarray(caps, np.int64),
                   np.asarray(fracs, np.float64), spans, points_of, profiles)

    @classmethod
    def max_capacity(cls, profiles,
                     budget_bytes: Optional[float] = None) -> "PriceTable":
        """One cell per knob at its full-budget capacity (``profiles.caps``)
        — the plain grid-estimation table (``CostSession.estimate_grid``)."""
        k = len(profiles.knobs)
        sizes = np.asarray(profiles.sizes, np.float64)
        fracs = ((budget_bytes - sizes) / budget_bytes
                 if budget_bytes else np.ones(k, np.float64))
        return cls(np.arange(k, dtype=np.int64),
                   np.asarray(profiles.caps, np.int64),
                   np.asarray(fracs, np.float64),
                   {kn: (i, i + 1) for i, kn in enumerate(profiles.knobs)},
                   {kn: {} for kn in profiles.knobs}, profiles)

    @classmethod
    def from_cells(cls, profiles, cells: Sequence[Tuple[object, int,
                                                        np.ndarray]]
                   ) -> "PriceTable":
        """Explicit (knob, profile row, capacity vector) cells — the
        capacity-curve shape (a join-tree level priced at every candidate
        pool share)."""
        rows, caps, spans, points_of = [], [], {}, {}
        for knob, row, cvec in cells:
            cvec = np.asarray(cvec, np.int64).ravel()
            start = len(rows)
            rows.extend([int(row)] * cvec.shape[0])
            caps.extend(cvec.tolist())
            spans[knob] = (start, len(rows))
            points_of[knob] = {}
        return cls(np.asarray(rows, np.int64), np.asarray(caps, np.int64),
                   np.zeros(len(rows), np.float64), spans, points_of,
                   profiles)

    def cross_policies(self, policies: Sequence[str]) -> "PriceTable":
        """Replicate every cell per eviction policy — policy becomes a knob.

        The p-th copy's cells carry policy id ``POLICIES.index(p)``; spans
        are re-keyed ``(policy, knob)`` and each knob point gains a
        ``"policy"`` entry, so the downstream argmin / ``TuneResult``
        treats the eviction policy exactly like any other knob axis.  One
        engine call then prices lru/fifo/lfu side-by-side — on the
        ``DeviceExecutor`` in ONE fused launch (the kernel's ``"multi"``
        mode selects the fixed point per row by policy id).
        """
        from repro_torch.core.cache_models import POLICIES
        policies = tuple(policies)
        if not policies:
            raise ValueError("cross_policies needs at least one policy")
        unknown = [p for p in policies if p not in POLICIES]
        if unknown:
            raise ValueError(f"unknown policies {unknown!r}; expected a "
                             f"subset of {POLICIES}")
        if len(set(policies)) != len(policies):
            raise ValueError(f"duplicate policies in {policies!r}")
        if self.pols is not None:
            raise ValueError("table already carries policy ids; "
                             "cross_policies must start from a plain table")
        n = len(self)
        reps = len(policies)
        spans, points_of = {}, {}
        for j, p in enumerate(policies):
            for kn, (a, b) in self.spans.items():
                spans[(p, kn)] = (a + j * n, b + j * n)
                points_of[(p, kn)] = dict(self.points_of[kn], policy=p)
        pols = np.repeat(np.asarray([POLICIES.index(p) for p in policies],
                                    np.int16), n)
        return PriceTable(np.tile(self.rows, reps), np.tile(self.caps, reps),
                          np.tile(self.fracs, reps), spans, points_of,
                          self.profiles, pols)

    # ---------------------------------------------------------- composition
    @classmethod
    def concat(cls, tables: Sequence["PriceTable"]) -> "PriceTable":
        """Concatenate tables over ONE shared ``GridProfiles`` — the
        sharded fleet shape: every per-shard table's cells price in a
        single engine call.  Knob keys must be globally unique."""
        tables = list(tables)
        if not tables:
            return cls(np.zeros(0, np.int64), np.zeros(0, np.int64),
                       np.zeros(0, np.float64), {}, {}, None)
        prof = tables[0].profiles
        if any(t.profiles is not prof for t in tables):
            raise ValueError("concat needs tables over one shared "
                             "GridProfiles (solve alignment)")
        spans, points_of, off = {}, {}, 0
        for t in tables:
            for kn, (a, b) in t.spans.items():
                if kn in spans:
                    raise ValueError(f"duplicate knob key {kn!r} across "
                                     "concatenated tables")
                spans[kn] = (a + off, b + off)
                points_of[kn] = t.points_of[kn]
            off += len(t)
        if all(t.pols is None for t in tables):
            pols = None
        else:
            # -1 (session default) fills plain tables so mixed concats keep
            # every cell's policy semantics
            pols = np.concatenate([
                t.pols if t.pols is not None
                else np.full(len(t), -1, np.int16) for t in tables])
        return cls(np.concatenate([t.rows for t in tables]),
                   np.concatenate([t.caps for t in tables]),
                   np.concatenate([t.fracs for t in tables]),
                   spans, points_of, prof, pols)

    def subset(self, sel) -> "PriceTable":
        """Slice cells back out of a (possibly concatenated) table.

        Each selected cell becomes a singleton span keyed by its owning
        knob — the sharded winner rehydration: after the fleet argmin picks
        a budget share, the cells at that share form a one-split-per-knob
        sub-table that ``finish_from_solution`` turns into a TuneResult.
        """
        sel = np.asarray(sel, np.int64)
        knob_of = {}
        for kn, (a, b) in self.spans.items():
            for t in range(a, b):
                knob_of[t] = kn
        return PriceTable(
            rows=self.rows[sel], caps=self.caps[sel], fracs=self.fracs[sel],
            spans={knob_of[int(t)]: (k, k + 1) for k, t in enumerate(sel)},
            points_of={knob_of[int(t)]: self.points_of[knob_of[int(t)]]
                       for t in sel},
            profiles=self.profiles,
            pols=None if self.pols is None else self.pols[sel])


@dataclasses.dataclass(frozen=True)
class PriceSolution:
    """One executor pass over a :class:`PriceTable` — all arrays cell-aligned.

    ``best_cell`` is the global objective argmin (first cell on ties, i.e.
    table order — which ``from_profiles``' max-split-first layout makes the
    largest buffer, reproducing the legacy tuners' tie-break).
    """

    table: PriceTable
    hit_rates: np.ndarray            # (T,) float64
    distinct: np.ndarray             # (T,) float64 distinct pages
    io: np.ndarray                   # (T,) (1 - h) * E[DAC] per query
    seconds: np.ndarray              # (T,) device-model objective
    objective: np.ndarray            # (T,) the ranked objective values
    objective_name: str
    best_cell: int
    executor: str

    def subset(self, sel) -> "PriceSolution":
        """The solution slice aligned with ``table.subset(sel)``."""
        sel = np.asarray(sel, np.int64)
        obj = self.objective[sel]
        return PriceSolution(
            self.table.subset(sel), self.hit_rates[sel], self.distinct[sel],
            self.io[sel], self.seconds[sel], obj, self.objective_name,
            int(np.argmin(obj)) if obj.shape[0] else -1, self.executor)


class PricingEngine:
    """profile -> solve -> argmin behind ONE call, bound to a CostSession.

    ``executor`` pins an executor for every ``price`` call (``"host"`` /
    ``"device"`` / an executor instance); ``None`` resolves per call — the
    ``REPRO_ENGINE_EXECUTOR`` env var if set, else ``device`` when the
    session's torch device is CUDA and ``host`` on the CPU.  ``calls`` counts ``price``
    invocations: every session runs exactly one per search, structurally
    asserted in the test suite.
    """

    def __init__(self, cost, executor=None):
        self.cost = cost
        self.executor = executor
        self.calls = 0
        self._instances: Dict[str, object] = {}

    # ------------------------------------------------------------- dispatch
    def _resolve(self, executor):
        if executor is None:
            executor = os.environ.get("REPRO_ENGINE_EXECUTOR") or None
        if executor is None:
            executor = self.executor
        if executor is None:
            executor = ("device" if self.cost.device.type == "cuda"
                        else "host")
        if not isinstance(executor, str):
            return executor
        if executor not in self._instances:
            if executor == "host":
                from repro_torch.engine.host import HostExecutor
                self._instances[executor] = HostExecutor()
            elif executor == "device":
                from repro_torch.engine.device import DeviceExecutor
                self._instances[executor] = DeviceExecutor()
            else:
                raise ValueError(f"unknown executor {executor!r}; expected "
                                 "'host' or 'device'")
        return self._instances[executor]

    # ---------------------------------------------------------------- price
    @obs.traced("cam.price")
    def price(self, table: PriceTable, *, objective: str = "io",
              executor=None) -> PriceSolution:
        """Solve every cell of ``table`` and rank by ``objective``.

        ``objective`` is ``"io"`` (expected physical I/Os per query,
        Eq. 15/16) or ``"seconds"`` (device-model-aware, §III-A
        composition).  Custom callable objectives stay downstream
        (``CamTuner.finish_from_solution`` evaluates them over the
        returned per-cell entries — still zero model calls).
        """
        if table.profiles is None:
            raise ValueError("PriceTable has no profiles attached; build it "
                             "with a GridProfiles (from_profiles / "
                             "max_capacity / from_cells)")
        if len(table) == 0:
            raise ValueError("cannot price an empty PriceTable")
        if objective not in ("io", "seconds"):
            raise ValueError(f"unknown objective {objective!r}; expected "
                             "'io' or 'seconds'")
        profiles = table.profiles
        dacs = np.asarray(profiles.dacs, np.float64)
        device = self.cost.system.device
        if device is None:
            run_cost = dacs
        else:
            run_cost = np.asarray([float(device.cost([d])) for d in dacs])
        row_scale = run_cost if objective == "seconds" else dacs

        exec_obj = self._resolve(executor)
        self.calls += 1
        h, n_distinct, best = exec_obj.solve(self, table, row_scale)
        h = np.asarray(h, np.float64)
        n_distinct = np.asarray(n_distinct, np.float64)
        io = (1.0 - h) * dacs[table.rows]
        seconds = io if device is None else (1.0 - h) * run_cost[table.rows]
        obj = io if objective == "io" else seconds
        if best is None:
            best = int(np.argmin(obj))
        return PriceSolution(table, h, n_distinct, io, seconds, obj,
                             objective, int(best), exec_obj.name)
