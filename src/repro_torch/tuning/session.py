"""TuningSession — ONE knob-tuning surface over declarative knob spaces (§V).

The tuning counterpart of the CostSession/JoinSession/JoinTreeSession
three-noun design.  Where the legacy tuners were three divergent function
bags (``pgm_tuner`` / ``rmi_tuner`` / ``rs_tuner``, now deprecated shims over
this module), everything here speaks four small abstractions:

* :class:`KnobSpace` — a declarative grid over an index family's tunable
  knobs, derived from the ``IndexModel.knobs()`` metadata the adapters
  publish (eps grids, branch grids, RadixSpline's ``radix_bits``, and
  cartesian products thereof);
* :class:`SizeModel` — footprint prediction WITHOUT construction: lazy
  power-law fits for the uniformly error-bounded families (the §V-B
  fitting trick, via ``tuning/fit.py``), the exact analytic formula for RMI
  (root + per-leaf parameters are fixed-size).  Budget-infeasible knob
  points are therefore skipped *before any index is built* and recorded in
  ``TuneResult.skipped`` with typed reasons;
* :class:`IndexBuilder` — a family bound to a key file: its knob space, its
  size model, candidate construction for the feasible points (RMI builds
  only here), and the deterministic in-memory profile score the
  cache-oblivious baselines optimize;
* :class:`Tuner` — a pluggable strategy: :class:`CamTuner` (the paper's
  cache-aware joint search), :class:`MulticriteriaTuner` (multicriteria-PGM:
  reserve a fixed buffer fraction, profile the candidates that fit the
  rest), :class:`CDFShopTuner` (CPU-optimal, I/O-oblivious).  All return a
  uniform :class:`TuneResult`.

The CAM search is *joint* over (knob, buffer-split fraction), the Eq. 15/16
trade-off solved on precomputed tables: ONE ``CostSession.grid_profiles``
pass produces every knob's capacity-independent profile (uniform-eps
candidates through the banded-matmul kernels, RMI branch grids through the
batched mixed-eps kernel), then ONE ``CostSession.solve_profiles`` call — the
many-histogram generalization of the ``hit_rate_curve`` /
``sorted_scan_miss_curve`` capacity-curve evaluators — prices the whole
(knob x split) table in a single batched pass.  Picking the argmin is pure
array lookups: ZERO per-split model calls, structurally asserted in
the test suite.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from typing import (Callable, Dict, NamedTuple, Optional, Protocol, Sequence,
                    Tuple, Union, runtime_checkable)

import numpy as np

from repro_torch.core.cam import CamEstimate
from repro_torch.core.session import (CostSession, GridCandidate, SkippedCandidate,
                                System)
from repro_torch.core.workload import Workload
from repro_torch.engine import PriceTable
from repro_torch.index import pgm as pgm_mod
from repro_torch.index import radixspline as rs_mod
from repro_torch.index import rmi as rmi_mod
from repro_torch.index.adapters import (ALEXAdapter, BTreeAdapter, PGMAdapter,
                                  RMIAdapter, RadixSplineAdapter)
from repro_torch.tuning import fit

__all__ = [
    "Knob",
    "KnobSpace",
    "SizeModel",
    "PowerLawSizeModel",
    "RadixSplineSizeModel",
    "AnalyticSizeModel",
    "TableSizeModel",
    "IndexBuilder",
    "PGMBuilder",
    "RMIBuilder",
    "RadixSplineBuilder",
    "ALEXBuilder",
    "BTreeBuilder",
    "builder_for",
    "SplitTable",
    "SplitEstimate",
    "TuneResult",
    "Tuner",
    "CamTuner",
    "MulticriteriaTuner",
    "CDFShopTuner",
    "TuningSession",
    "DEFAULT_SPLITS",
]

#: Candidate buffer fractions of the shared budget enumerated by the joint
#: (knob x split) search, in addition to each knob's maximal feasible split
#: (all memory the index does not claim).  The maximum split is listed first
#: per knob, so objective ties resolve toward the larger buffer — exactly
#: what the legacy tuners (which always took the maximum) chose.
DEFAULT_SPLITS = (0.25, 0.5, 0.75)


# ---------------------------------------------------------------------------
# Declarative knob spaces
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Knob:
    """One tunable axis: a name and the grid of values to sweep."""

    name: str
    values: Tuple[object, ...]
    kind: str = "knob"


@dataclasses.dataclass(frozen=True)
class KnobSpace:
    """Cartesian grid over an index family's tunable knobs.

    Derived from ``IndexModel.knobs()``-style metadata: every ``tunable``
    entry carrying a ``grid`` becomes an axis (RadixSpline's
    (eps x radix_bits) plane, PGM's eps line, RMI's branch line).
    ``overrides`` replaces an axis' grid — a scalar override pins the axis
    to a single value.
    """

    knobs: Tuple[Knob, ...]

    @classmethod
    def from_metadata(cls, metadata: Dict[str, dict],
                      overrides: Optional[Dict[str, object]] = None
                      ) -> "KnobSpace":
        overrides = dict(overrides or {})
        axes = []
        for name, meta in metadata.items():
            if name in overrides:
                grid = overrides.pop(name)
                if np.isscalar(grid):
                    grid = (grid,)
                axes.append(Knob(name, tuple(grid),
                                 meta.get("kind", "knob")))
            elif meta.get("tunable") and "grid" in meta:
                axes.append(Knob(name, tuple(meta["grid"]),
                                 meta.get("kind", "knob")))
        if overrides:
            raise ValueError(f"overrides name unknown knobs: "
                             f"{sorted(overrides)}; metadata has "
                             f"{sorted(metadata)}")
        if not axes:
            raise ValueError("knob space has no tunable axes")
        return cls(tuple(axes))

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(k.name for k in self.knobs)

    def points(self) -> Tuple[Dict[str, object], ...]:
        """Cartesian product, first axis outermost (stable tuning order)."""
        names = self.names
        return tuple(dict(zip(names, combo)) for combo in
                     itertools.product(*(k.values for k in self.knobs)))

    def key(self, point: Dict[str, object]):
        """Estimate-dict key for a point: the bare value for 1-D spaces
        (legacy ``estimates[eps]`` compatibility), a tuple otherwise."""
        if len(self.knobs) == 1:
            return point[self.knobs[0].name]
        return tuple(point[n] for n in self.names)


# ---------------------------------------------------------------------------
# Size models: footprint prediction without construction
# ---------------------------------------------------------------------------

@runtime_checkable
class SizeModel(Protocol):
    """Predicts an index footprint in bytes from knob values.

    ``model(eps=64)`` / ``model(branch=1024)`` /
    ``model(eps=64, radix_bits=12)`` — called once per knob point during
    feasibility filtering, BEFORE any candidate index exists.
    """

    def __call__(self, **knobs) -> float: ...


@dataclasses.dataclass
class PowerLawSizeModel:
    """Lazy ``a * eps^-b + c`` fit from a few sampled builds (§V-B).

    The multicriteria-PGM fitting trick: construction happens only for
    ``sample_eps`` (and only on first use), after which the dense eps grid
    prices through the closed form.
    """

    build_size: Callable[[int], float]
    sample_eps: Tuple[int, ...] = (16, 64, 256, 1024)
    _fit: Optional[fit.PowerLawFit] = dataclasses.field(default=None,
                                                        repr=False)
    fit_seconds: float = 0.0

    @property
    def fitted(self) -> fit.PowerLawFit:
        if self._fit is None:
            t0 = time.perf_counter()
            sizes = [float(self.build_size(e)) for e in self.sample_eps]
            self._fit = fit.fit_power_law(list(self.sample_eps), sizes)
            self.fit_seconds = time.perf_counter() - t0
        return self._fit

    def __call__(self, eps: int, **_ignored) -> float:
        return float(self.fitted(eps))


@dataclasses.dataclass
class RadixSplineSizeModel:
    """2-D RadixSpline footprint: fitted spline knots + analytic radix table.

    The knot count shrinks as a power law of the corridor eps (fitted from
    sampled builds at ``ref_radix_bits``, table bytes subtracted), while the
    radix table is exactly ``4 * (2^bits + 1)`` bytes — so the whole
    (eps x radix_bits) plane prices from ONE sampled 1-D fit.
    """

    keys: np.ndarray
    sample_eps: Tuple[int, ...] = (16, 64, 256, 1024)
    ref_radix_bits: int = 12
    _spline_fit: Optional[PowerLawSizeModel] = dataclasses.field(
        default=None, repr=False)

    @staticmethod
    def table_bytes(radix_bits: int) -> float:
        return 4.0 * (2 ** int(radix_bits) + 1)

    def __call__(self, eps: int, radix_bits: Optional[int] = None,
                 **_ignored) -> float:
        if self._spline_fit is None:
            ref_table = self.table_bytes(self.ref_radix_bits)
            self._spline_fit = PowerLawSizeModel(
                lambda e: rs_mod.build_radixspline(
                    self.keys, e, self.ref_radix_bits).size_bytes - ref_table,
                self.sample_eps)
        bits = self.ref_radix_bits if radix_bits is None else radix_bits
        return float(self._spline_fit(eps)) + self.table_bytes(bits)


@dataclasses.dataclass(frozen=True)
class AnalyticSizeModel:
    """Exact closed-form footprint (RMI: fixed-size root + per-leaf params).

    No sampling, no builds — which is what lets the tuner drop
    budget-infeasible branch factors before paying an O(n) construction.
    """

    fn: Callable[..., float]

    def __call__(self, **knobs) -> float:
        return float(self.fn(**knobs))


@dataclasses.dataclass(frozen=True)
class TableSizeModel:
    """Exact per-point sizes from already-built indexes (benchmark replays
    that must agree with replay capacities bit-for-bit)."""

    sizes: Dict[object, float]
    names: Tuple[str, ...] = ("eps",)

    def __call__(self, **knobs) -> float:
        key = (knobs[self.names[0]] if len(self.names) == 1
               else tuple(knobs[n] for n in self.names))
        return float(self.sizes[key])


# ---------------------------------------------------------------------------
# Index builders: a family bound to a key file
# ---------------------------------------------------------------------------

@runtime_checkable
class IndexBuilder(Protocol):
    """What ``TuningSession`` needs from an index family."""

    family: str
    keys: np.ndarray

    def knob_space(self, overrides: Optional[Dict[str, object]] = None
                   ) -> KnobSpace: ...

    def size_model(self) -> SizeModel: ...

    def candidate(self, point: Dict[str, object],
                  size_bytes: float) -> GridCandidate: ...

    def build(self, point: Dict[str, object]): ...

    def profile_score(self, point: Dict[str, object],
                      probe_keys: np.ndarray) -> float: ...


@dataclasses.dataclass
class PGMBuilder:
    """PGM family: uniform eps knob, power-law size model, no builds in the
    CAM grid (candidates are ``GridCandidate(eps=...)``)."""

    keys: np.ndarray
    sample_eps: Tuple[int, ...] = (16, 64, 256, 1024)
    family: str = "pgm"
    built: Dict[object, PGMAdapter] = dataclasses.field(default_factory=dict)
    _size_model: Optional[PowerLawSizeModel] = dataclasses.field(
        default=None, repr=False)

    def knob_space(self, overrides=None) -> KnobSpace:
        return KnobSpace.from_metadata(PGMAdapter.knob_metadata(), overrides)

    def size_model(self) -> PowerLawSizeModel:
        if self._size_model is None:
            self._size_model = PowerLawSizeModel(
                lambda e: pgm_mod.build_pgm(self.keys, e).size_bytes,
                self.sample_eps)
        return self._size_model

    def candidate(self, point, size_bytes) -> GridCandidate:
        return GridCandidate(knob=point["eps"], eps=int(point["eps"]),
                             size_bytes=float(size_bytes))

    def build(self, point) -> PGMAdapter:
        key = point["eps"]
        if key not in self.built:
            self.built[key] = PGMAdapter.build(self.keys, int(point["eps"]))
        return self.built[key]

    def profile_score(self, point, probe_keys) -> float:
        """The multicriteria optimizer's deterministic in-memory lookup
        cost: traversal levels + log2 last-mile steps (the profiling pass
        itself — a real build + predict — is charged to tuning time)."""
        idx = self.build(point).index
        idx.predict(probe_keys)                       # the profiling pass
        return 1.5 * len(idx.levels) + float(
            np.log2(2 * point["eps"] + 1))


@dataclasses.dataclass
class RMIBuilder:
    """RMI family: branch-factor knob, EXACT analytic size model (so
    budget-infeasible branches are never constructed), candidates built
    lazily for the feasible points only and profiled through the batched
    mixed-eps kernel."""

    keys: np.ndarray
    family: str = "rmi"
    built: Dict[object, RMIAdapter] = dataclasses.field(default_factory=dict)

    def knob_space(self, overrides=None) -> KnobSpace:
        return KnobSpace.from_metadata(RMIAdapter.knob_metadata(), overrides)

    def size_model(self) -> AnalyticSizeModel:
        return AnalyticSizeModel(
            lambda branch: rmi_mod.rmi_size_bytes(int(branch)))

    def candidate(self, point, size_bytes) -> GridCandidate:
        adapter = self.build(point)
        return GridCandidate(knob=point["branch"],
                             size_bytes=float(adapter.size_bytes),
                             index=adapter)

    def build(self, point) -> RMIAdapter:
        key = point["branch"]
        if key not in self.built:
            self.built[key] = RMIAdapter.build(self.keys,
                                               int(point["branch"]))
        return self.built[key]

    def profile_score(self, point, probe_keys) -> float:
        """CDFShop's deterministic CPU score: model evals + log2 last-mile
        steps over the mean leaf error (profiling pass included)."""
        idx = self.build(point).index
        idx.window(probe_keys)                        # the profiling pass
        return 2.0 + float(np.log2(2.0 * idx.leaf_eps.mean() + 1.0))


@dataclasses.dataclass
class RadixSplineBuilder:
    """RadixSpline family: the 2-D (corridor eps x radix_bits) knob plane.

    The spline profile depends only on eps (the radix table accelerates
    in-memory knot search, not disk windows), so every (eps, radix_bits)
    point shares the banded uniform-eps kernels — radix_bits enters purely
    through the footprint, which is exactly the Eq. 15/16 trade-off: wider
    tables steal buffer pages.
    """

    keys: np.ndarray
    sample_eps: Tuple[int, ...] = (16, 64, 256, 1024)
    ref_radix_bits: int = 12
    family: str = "radixspline"
    built: Dict[object, RadixSplineAdapter] = dataclasses.field(
        default_factory=dict)
    _size_model: Optional[RadixSplineSizeModel] = dataclasses.field(
        default=None, repr=False)

    def knob_space(self, overrides=None) -> KnobSpace:
        return KnobSpace.from_metadata(RadixSplineAdapter.knob_metadata(),
                                       overrides)

    def size_model(self) -> RadixSplineSizeModel:
        if self._size_model is None:
            self._size_model = RadixSplineSizeModel(
                self.keys, self.sample_eps, self.ref_radix_bits)
        return self._size_model

    def candidate(self, point, size_bytes) -> GridCandidate:
        return GridCandidate(knob=(point["eps"], point["radix_bits"]),
                             eps=int(point["eps"]),
                             size_bytes=float(size_bytes))

    def build(self, point) -> RadixSplineAdapter:
        key = (point["eps"], point["radix_bits"])
        if key not in self.built:
            self.built[key] = RadixSplineAdapter.build(
                self.keys, int(point["eps"]), int(point["radix_bits"]))
        return self.built[key]

    def profile_score(self, point, probe_keys) -> float:
        idx = self.build(point).index
        idx.predict(probe_keys)                       # the profiling pass
        narrowed = max(0.0, float(np.log2(max(len(idx.knots_key), 2)))
                       - point["radix_bits"])
        return 1.0 + narrowed + float(np.log2(2 * point["eps"] + 1))


@dataclasses.dataclass
class ALEXBuilder:
    """ALEX family: gap-density knob, exact analytic size model.

    Candidates are index-backed (the slot-space remap differs per knob, so
    the shared uniform-eps grid over one ``n`` cannot represent them), but
    "building" is O(1) — the adapter is a layout model, not a structure —
    so the whole gap grid still prices in one grouped profile pass, write
    streams included.
    """

    keys: np.ndarray
    eps: int = 64
    family: str = "alex"
    built: Dict[object, ALEXAdapter] = dataclasses.field(default_factory=dict)

    def knob_space(self, overrides=None) -> KnobSpace:
        return KnobSpace.from_metadata(ALEXAdapter.knob_metadata(), overrides)

    def size_model(self) -> AnalyticSizeModel:
        n = int(np.asarray(self.keys).shape[0])
        return AnalyticSizeModel(
            lambda gap_density: ALEXAdapter(n, float(gap_density),
                                            self.eps).size_bytes)

    def candidate(self, point, size_bytes) -> GridCandidate:
        adapter = self.build(point)
        return GridCandidate(knob=point["gap_density"],
                             size_bytes=float(size_bytes), index=adapter)

    def build(self, point) -> ALEXAdapter:
        key = point["gap_density"]
        if key not in self.built:
            self.built[key] = ALEXAdapter.build(
                self.keys, float(point["gap_density"]), self.eps)
        return self.built[key]

    def profile_score(self, point, probe_keys) -> float:
        """Deterministic in-memory score: root model eval + exponential
        search over the eps corridor (gap slack does not change CPU cost —
        which is precisely why cache-oblivious tuners cannot rank it)."""
        self.build(point).window(probe_keys)          # the profiling pass
        return 1.0 + float(np.log2(2 * self.eps + 1))


@dataclasses.dataclass
class BTreeBuilder:
    """B+-tree family: leaf fill-factor knob, exact analytic size model."""

    keys: np.ndarray
    family: str = "btree"
    built: Dict[object, BTreeAdapter] = dataclasses.field(
        default_factory=dict)

    def knob_space(self, overrides=None) -> KnobSpace:
        return KnobSpace.from_metadata(BTreeAdapter.knob_metadata(),
                                       overrides)

    def size_model(self) -> AnalyticSizeModel:
        n = int(np.asarray(self.keys).shape[0])
        return AnalyticSizeModel(
            lambda fill_factor: BTreeAdapter(n,
                                             float(fill_factor)).size_bytes)

    def candidate(self, point, size_bytes) -> GridCandidate:
        adapter = self.build(point)
        return GridCandidate(knob=point["fill_factor"],
                             size_bytes=float(size_bytes), index=adapter)

    def build(self, point) -> BTreeAdapter:
        key = point["fill_factor"]
        if key not in self.built:
            self.built[key] = BTreeAdapter.build(self.keys,
                                                 float(point["fill_factor"]))
        return self.built[key]

    def profile_score(self, point, probe_keys) -> float:
        """Resident inner-node descent: log_fanout(n) comparisons levels."""
        adapter = self.build(point)
        adapter.window(probe_keys)                    # the profiling pass
        return float(np.log(max(adapter.n, 2)) / np.log(256.0)) + 1.0


_BUILDERS = {"pgm": PGMBuilder, "rmi": RMIBuilder,
             "radixspline": RadixSplineBuilder, "alex": ALEXBuilder,
             "btree": BTreeBuilder}


def builder_for(family: str, keys: np.ndarray, **kwargs) -> IndexBuilder:
    """Builder registry: ``builder_for("pgm", keys)`` etc."""
    if family not in _BUILDERS:
        raise ValueError(f"unknown index family {family!r}; expected one of "
                         f"{sorted(_BUILDERS)}")
    return _BUILDERS[family](keys, **kwargs)


# ---------------------------------------------------------------------------
# Results
# ---------------------------------------------------------------------------

#: The joint (knob x split) solve table IS the engine's canonical table IR;
#: the alias keeps the tuning-era name.
SplitTable = PriceTable


class SplitEstimate(NamedTuple):
    """One (knob, buffer split) cell of the joint search table."""

    split: float              # buffer fraction of the shared budget
    capacity_pages: int
    io: float                 # (1 - h) * E[DAC] per query
    hit_rate: float
    dac: float
    size_bytes: float
    seconds: float            # device-model objective (== io under DAM)


@dataclasses.dataclass
class TuneResult:
    """Uniform result of every tuner strategy.

    ``best`` is the chosen knob point (name -> value), ``split`` the chosen
    buffer fraction, ``estimates`` each knob's CamEstimate at its own best
    split (CAM tuners; baselines estimate nothing and leave it empty), and
    ``table`` the full joint (knob x split) table the argmin ran over.
    ``skipped`` carries typed reasons — budget-infeasible points recorded
    from the SIZE MODEL, before any build.  ``batched_solves`` counts the
    cache-model solve passes: the joint search does exactly one, however
    many splits are enumerated.
    """

    family: str
    tuner: str
    objective: str
    best: Dict[str, object]
    best_knob: object
    split: float
    capacity_pages: int
    est_io: float
    objective_value: float
    estimates: Dict[object, CamEstimate]
    table: Dict[object, Tuple[SplitEstimate, ...]]
    skipped: Tuple[SkippedCandidate, ...]
    tuning_seconds: float
    batched_solves: int = 0
    size_model: Optional[SizeModel] = None


# ---------------------------------------------------------------------------
# Tuner strategies
# ---------------------------------------------------------------------------

@runtime_checkable
class Tuner(Protocol):
    name: str

    def tune(self, session: "TuningSession", builder: IndexBuilder,
             workload: Workload, space: KnobSpace, objective,
             sample_rate: float, seed: int,
             size_model: Optional[SizeModel]) -> TuneResult: ...


def _feasibility_split(points, space, size_model, system):
    """Size-model feasibility BEFORE any construction (typed skips)."""
    feasible, skipped = [], []
    for pt in points:
        size = float(size_model(**pt))
        if system.capacity_for(size) >= 1:
            feasible.append((pt, size))
        else:
            skipped.append(SkippedCandidate(
                space.key(pt),
                f"predicted {size:.0f} B footprint leaves no buffer page "
                f"under the {system.memory_budget_bytes:.0f} B budget"))
    return feasible, skipped


@dataclasses.dataclass
@dataclasses.dataclass
class CamTuner:
    """The paper's tuner: cache-aware joint (knob x buffer split) search.

    One ``grid_profiles`` pass (capacity-independent), one
    ``solve_profiles`` pass over the whole (knob x split) table, then pure
    array argmin — zero per-split model calls.

    ``policies`` makes the EVICTION POLICY a knob: the assembled table is
    crossed with the given ``cache_models.POLICIES`` names
    (``PriceTable.cross_policies``), so the single engine call prices
    every (knob x split x policy) cell — side by side in ONE fused launch
    on the device executor — and the winning point carries a ``"policy"``
    entry.  ``None`` (default) prices under the session's configured
    policy, exactly as before.

    Objectives:

    * ``"io"``      — expected physical I/Os per query, Eq. 15/16;
    * ``"seconds"`` — device-model-aware: each miss event issues one device
      op whose run length is the query's data-access span, so
      ``seconds = miss_rate * device.cost([E[DAC]])`` (§III-A composition;
      under the unit-cost DAM, or with no ``System.device``, this equals
      ``"io"``).  A seek-heavy device weighs the op term against the
      transfer term differently than raw page counts do, and can therefore
      pick a different knob than ``"io"``;
    * a callable ``f(point, SplitEstimate) -> float`` — custom metric,
      evaluated over the precomputed table (still no model calls); e.g. a
      memory-frugality penalty that prefers sub-maximal splits.
    """

    policies: Optional[Tuple[str, ...]] = None
    name: str = "cam"

    def tune(self, session, builder, workload, space, objective,
             sample_rate, seed, size_model) -> TuneResult:
        t0 = time.perf_counter()
        system = session.system
        cost = session.cost
        size_model = size_model if size_model is not None \
            else builder.size_model()
        feasible, skipped = _feasibility_split(
            space.points(), space, size_model, system)
        if not feasible:
            raise ValueError("memory budget too small for any candidate "
                             "index")
        # Construction happens here and only here — for the feasible points
        # of index-backed families (RMI); uniform-eps families build nothing.
        cands = [builder.candidate(pt, size) for pt, size in feasible]
        profiles = cost.grid_profiles(cands, workload, sample_rate, seed)
        skipped.extend(profiles.skipped)
        points = {space.key(pt): pt for pt, _size in feasible}
        return self.tune_profiles(
            session, builder, space, profiles, points=points,
            objective=objective, size_model=size_model,
            skipped=skipped, t0=t0)

    def tune_profiles(self, session, builder, space, profiles, *,
                      points: Optional[Dict[object, Dict[str, object]]] = None,
                      objective="io", size_model=None,
                      skipped: Sequence[SkippedCandidate] = (),
                      t0: Optional[float] = None) -> TuneResult:
        """Joint (knob x split) search on PRECOMPUTED profiles.

        The solve-and-argmin half of :meth:`tune`, callable with any
        capacity-independent :class:`GridProfiles` — in particular one
        assembled incrementally from serving sketches
        (``GridProfiles.from_accumulated``).  Runs NO profiling pass: the
        only model call is the single batched ``solve_profiles`` over the
        (knob x split) table, which is what lets the serving loop retune
        from sketches without replaying or re-profiling the trace.

        ``points`` maps each profile knob key to its knob-space point; when
        omitted it is reconstructed from ``space.points()``.
        """
        t0 = time.perf_counter() if t0 is None else t0
        system = session.system
        cost = session.cost
        if points is None:
            by_key = {}
            for pt in space.points():
                by_key.setdefault(space.key(pt), pt)
            points = {kn: by_key[kn] for kn in profiles.knobs
                      if kn in by_key}
        table = self.assemble_table(
            profiles, points, splits=session.splits,
            budget_bytes=system.memory_budget_bytes,
            page_bytes=system.geom.page_bytes)
        if self.policies:
            # policy-as-a-knob: cross every (knob x split) cell with the
            # candidate eviction policies — still ONE engine call below
            table = table.cross_policies(self.policies)
        # ----- ONE engine call prices the whole table ---------------------
        sol = cost.engine.price(
            table, objective=objective if objective == "seconds" else "io")
        return self.finish_from_solution(
            session, builder, space, profiles, table, sol.hit_rates,
            sol.distinct, objective=objective, size_model=size_model,
            skipped=skipped, t0=t0)

    @staticmethod
    def assemble_table(profiles, points, *, splits, budget_bytes,
                       page_bytes, index_in_split: bool = False,
                       include_max_split: bool = True) -> SplitTable:
        """The joint (knob x split) table — delegates to
        :meth:`repro_torch.engine.PriceTable.from_profiles`, where the assembly
        semantics (max-split-first tie ordering, ``index_in_split`` fleet
        capacities) now live."""
        return PriceTable.from_profiles(
            profiles, points, splits=splits, budget_bytes=budget_bytes,
            page_bytes=page_bytes, index_in_split=index_in_split,
            include_max_split=include_max_split)

    def finish_from_solution(self, session, builder, space, profiles,
                             table: SplitTable, h, n_distinct, *,
                             objective="io", size_model=None,
                             skipped: Sequence[SkippedCandidate] = (),
                             t0: Optional[float] = None,
                             batched_solves: int = 1) -> TuneResult:
        """Argmin + result assembly over an ALREADY-SOLVED table.

        ``h``/``n_distinct`` are :meth:`CostSession.solve_profiles` outputs
        aligned with ``table``'s cells; everything here is array lookups —
        no model calls — so a caller that solved MANY concatenated tables
        at once (the sharded fleet search) can finish each table's slice
        separately without re-solving.
        """
        t0 = time.perf_counter() if t0 is None else t0
        system = session.system
        cost = session.cost
        skipped = list(skipped)
        spans, points_of = table.spans, table.points_of
        rows_arr, caps_arr, fracs = table.rows, table.caps, table.fracs
        h = np.asarray(h, np.float64)
        n_distinct = np.asarray(n_distinct, np.float64)
        dacs = profiles.dacs[rows_arr]
        sizes = profiles.sizes[rows_arr]
        io = (1.0 - h) * dacs
        device = system.device
        if device is None:
            seconds = io
        else:
            run_cost = np.asarray([float(device.cost([d]))
                                   for d in profiles.dacs])
            seconds = (1.0 - h) * run_cost[rows_arr]

        entries = {
            knob: tuple(SplitEstimate(float(fracs[j]), int(caps_arr[j]),
                                      float(io[j]), float(h[j]),
                                      float(dacs[j]), float(sizes[j]),
                                      float(seconds[j]))
                        for j in range(a, b))
            for knob, (a, b) in spans.items()}

        if objective == "io":
            obj = io
            obj_name = "io"
        elif objective == "seconds":
            obj = seconds
            obj_name = "seconds"
        elif callable(objective):
            obj = np.asarray([
                objective(points_of[knob], e)
                for knob, (a, b) in spans.items()
                for e in entries[knob]])
            obj_name = getattr(objective, "__name__", "custom")
        else:
            raise ValueError(f"unknown objective {objective!r}; expected "
                             "'io', 'seconds', or a callable")

        # ----- argmin + per-knob estimates: array lookups only ------------
        per_cand = (time.perf_counter() - t0) / max(len(spans), 1)
        estimates: Dict[object, CamEstimate] = {}
        best_knob, best_j, best_val = None, -1, np.inf
        for knob, (a, b) in spans.items():
            j = a + int(np.argmin(obj[a:b]))
            if obj[j] < best_val:
                best_knob, best_j, best_val = knob, j, float(obj[j])
            # the span's first cell names the knob's profile row (every
            # cell of a span shares one row) — valid for plain AND
            # policy-crossed tables, whose (policy, knob) keys are not
            # profile knob keys
            i = int(rows_arr[a])
            estimates[knob] = CamEstimate(
                io_per_query=float(io[j]), hit_rate=float(h[j]),
                dac=float(dacs[j]), capacity_pages=int(caps_arr[j]),
                total_refs=(float(profiles.totals[i])
                            + profiles.sorted_refs(i)) * profiles.scale,
                distinct_pages=float(n_distinct[j]),
                estimation_seconds=per_cand,
                policy=points_of[knob].get("policy", system.policy),
                device_cost=cost._device_cost(float(io[j])))
        if best_knob is None:
            raise ValueError("no knob point survived profiling")
        return TuneResult(
            family=builder.family, tuner=self.name, objective=obj_name,
            best=dict(points_of[best_knob]), best_knob=best_knob,
            split=float(fracs[best_j]), capacity_pages=int(caps_arr[best_j]),
            est_io=float(io[best_j]), objective_value=float(obj[best_j]),
            estimates=estimates, table=entries, skipped=tuple(skipped),
            tuning_seconds=time.perf_counter() - t0,
            batched_solves=batched_solves, size_model=size_model)


@dataclasses.dataclass
class _ProfilingBaseline:
    """Shared body of the cache-oblivious baselines: reserve a fixed buffer
    fraction, build-and-profile the candidates whose PREDICTED size fits
    the remaining index-space budget, score them with the family's
    deterministic in-memory cost.  Buffer interaction is invisible to the
    score by construction — that is the point of the baseline."""

    buffer_fraction: float = 0.5
    profile_lookups: int = 20_000
    max_profiled: Optional[int] = None
    name: str = "baseline"

    def tune(self, session, builder, workload, space, objective,
             sample_rate, seed, size_model) -> TuneResult:
        t0 = time.perf_counter()
        system = session.system
        size_model = size_model if size_model is not None \
            else builder.size_model()
        index_budget = (1.0 - self.buffer_fraction) \
            * system.memory_budget_bytes
        points = space.points()
        feasible, skipped = [], []
        for pt in points:
            size = float(size_model(**pt))
            if size <= index_budget:
                feasible.append(pt)
            else:
                skipped.append(SkippedCandidate(
                    space.key(pt),
                    f"predicted {size:.0f} B footprint exceeds the "
                    f"{index_budget:.0f} B reserved index space"))
        if not feasible:
            # Legacy fallbacks when nothing fits the reserved index space:
            # multicriteria takes the COARSEST candidate (smallest predicted
            # footprint, max eps — grid-order independent), CDFShop its
            # grid's first entry.
            if self.name == "multicriteria":
                feasible = [min(points,
                                key=lambda pt: float(size_model(**pt)))]
            else:
                feasible = [points[0]]
        if self.max_profiled is not None:
            feasible = feasible[:self.max_profiled]
        rng = np.random.default_rng(0)
        probe = builder.keys[rng.integers(0, len(builder.keys),
                                          size=self.profile_lookups)]
        best_pt, best_score = None, np.inf
        for pt in feasible:
            score = builder.profile_score(pt, probe)
            if score < best_score:
                best_pt, best_score = pt, score
        best_knob = space.key(best_pt)
        size = float(size_model(**best_pt))
        cap = system.capacity_for(size)
        return TuneResult(
            family=builder.family, tuner=self.name, objective="cpu_profile",
            best=dict(best_pt), best_knob=best_knob,
            split=self.buffer_fraction, capacity_pages=cap,
            est_io=float("nan"), objective_value=float(best_score),
            estimates={}, table={}, skipped=tuple(skipped),
            tuning_seconds=time.perf_counter() - t0, batched_solves=0,
            size_model=size_model)


@dataclasses.dataclass
class MulticriteriaTuner(_ProfilingBaseline):
    """Multicriteria-PGM baseline (time-minimization-given-space mode):
    profiles the first ``max_profiled`` feasible candidates, picks the
    fastest in-memory one; falls back to the coarsest point when nothing
    fits the reserved index space."""

    max_profiled: Optional[int] = 10
    name: str = "multicriteria"


@dataclasses.dataclass
class CDFShopTuner(_ProfilingBaseline):
    """CDFShop-style baseline: CPU-optimal configuration, I/O-oblivious;
    profiles every candidate within the reserved index space (legacy
    behavior built even the infeasible ones first — the size-model path
    skips those builds, selection unchanged)."""

    name: str = "cdfshop"


# ---------------------------------------------------------------------------
# The session
# ---------------------------------------------------------------------------

class TuningSession:
    """Knob tuning bound to ONE :class:`System` (the three-noun pattern).

    ``tune(builder, workload)`` runs a :class:`Tuner` strategy (CAM by
    default) over the builder's declarative knob space under the system's
    shared index+buffer memory budget.  ``budget=`` tunes under a different
    budget without rebinding (a replaced System view); ``splits`` overrides
    the candidate buffer fractions of the joint search.
    """

    def __init__(self, system: System,
                 splits: Sequence[float] = DEFAULT_SPLITS):
        self.system = system
        self.cost = CostSession(system)
        self.splits = tuple(splits)

    def tune(self, builder: IndexBuilder, workload: Workload,
             budget: Optional[float] = None, *,
             objective: Union[str, Callable] = "io",
             tuner: Optional[Tuner] = None,
             overrides: Optional[Dict[str, object]] = None,
             knob_space: Optional[KnobSpace] = None,
             size_model: Optional[SizeModel] = None,
             policies: Optional[Sequence[str]] = None,
             sample_rate: float = 1.0, seed: int = 0) -> TuneResult:
        session = self
        if budget is not None:
            session = TuningSession(
                dataclasses.replace(self.system,
                                    memory_budget_bytes=float(budget)),
                self.splits)
        space = knob_space if knob_space is not None \
            else builder.knob_space(overrides)
        if policies is not None and tuner is not None:
            raise ValueError("policies= configures the CAM tuner; pass "
                             "CamTuner(policies=...) explicitly instead of "
                             "combining it with tuner=")
        strategy = tuner if tuner is not None \
            else CamTuner(policies=tuple(policies) if policies else None)
        return strategy.tune(session, builder, workload, space, objective,
                             sample_rate, seed, size_model)

    def tune_from_profiles(self, builder: IndexBuilder, profiles,
                           budget: Optional[float] = None, *,
                           objective: Union[str, Callable] = "io",
                           overrides: Optional[Dict[str, object]] = None,
                           knob_space: Optional[KnobSpace] = None,
                           size_model: Optional[SizeModel] = None,
                           policies: Optional[Sequence[str]] = None,
                           ) -> TuneResult:
        """Joint (knob x split) retune on PRECOMPUTED profiles.

        The serving loop's retune path: ``profiles`` is a capacity-
        independent :class:`GridProfiles` — typically assembled
        incrementally by a workload sketch (``WindowSketch.to_profiles``)
        rather than by a ``grid_profiles`` pass — and this method runs only
        the solve-and-argmin half of :meth:`tune`.  No trace replay, no
        re-profiling: exactly one batched ``solve_profiles`` call.
        """
        session = self
        if budget is not None:
            session = TuningSession(
                dataclasses.replace(self.system,
                                    memory_budget_bytes=float(budget)),
                self.splits)
        space = knob_space if knob_space is not None \
            else builder.knob_space(overrides)
        tuner = CamTuner(policies=tuple(policies) if policies else None)
        return tuner.tune_profiles(
            session, builder, space, profiles,
            objective=objective, size_model=size_model)
