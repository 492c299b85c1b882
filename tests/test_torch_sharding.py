"""The port's sharding layer (routing, the joint fleet solve, rebalance)
against the JAX reference, on the CPU.

Both packages get the same key file, the same workloads (one numpy seed
each) and the same analytic index-size model.  Port sessions run with
``torch_device="cpu"``; their pricing executor is pinned per session
(``PricingEngine(cost, executor=...)``) to ``"host"`` or ``"device"`` (on
CPU tensors the latter runs ``price_grid_ref``), and the JAX side is
pinned to the same executor.  Bounds:

* exact: routed workloads and ``RouteStats``, boundary candidates, the
  chosen boundaries, budget fractions, knobs and capacities, the hot shard,
  ``switched``, cells solved, and the structural counts (one grouped
  profile pass and one engine call per solve);
* <= 2e-6: hit rates of the solved table;
* rtol 1e-5: fleet I/O, I/O per query, per-boundary totals, move I/O.
"""
import importlib
import io
from contextlib import redirect_stdout

import numpy as np
import pytest

from repro.core.cam import CamGeometry as JGeom
from repro.core.session import CostSession as JCost
from repro.core.session import GridCandidate as JCand
from repro.core.session import System as JSystem
from repro.core.workload import Workload as JW
from repro.engine import PricingEngine as JEngine
from repro.serving.sketch import shard_page_masses as jmasses
from repro.sharding import session as jsess
from repro.sharding import system as jsys
from repro.tuning import session as jtun
from repro_torch.core.cam import CamGeometry
from repro_torch.core.session import CostSession, GridCandidate, System
from repro_torch.core.workload import Workload
from repro_torch.engine import PricingEngine
from repro_torch.launch import bench_sharding
from repro_torch.serving.sketch import shard_page_masses as tmasses
from repro_torch.sharding import session as tsess
from repro_torch.sharding import system as tsys
from repro_torch.tuning import session as ttun

# the packages export a ``route`` function that shadows the module's name
jroute = importlib.import_module("repro.sharding.route")
troute = importlib.import_module("repro_torch.sharding.route")
POLICIES = ("lru", "fifo", "lfu")
EXECUTORS = ("host", "device")
IO_RTOL = 1e-5
H_ATOL = 2e-6
N_KEYS = 8192
KEYS = np.sort(np.random.default_rng(0).uniform(0, 1e6, N_KEYS))
GEOM_KW = dict(c_ipp=64, page_bytes=4096)
OVR = {"eps": (4, 64)}


def _size_model(eps):
    # one analytic footprint for both packages (the fitted power law
    # differs between them within its own sensitivity, ROADMAP Queue 3)
    return 16.0 * N_KEYS / (2.0 * eps) + 64.0


def _systems(budget, policy="lru"):
    return (JSystem(JGeom(**GEOM_KW), memory_budget_bytes=budget,
                    policy=policy),
            System(CamGeometry(**GEOM_KW), memory_budget_bytes=budget,
                   policy=policy, torch_device="cpu"))


def _sessions(n_shards=4, grid=8, budget=8 * 1024, policy="lru",
              executor="host"):
    js_, ts_ = _systems(budget, policy)
    j = jsess.ShardingSession(js_, jtun.PGMBuilder(KEYS), n_shards,
                              grid=grid, overrides=OVR,
                              size_model=jtun.AnalyticSizeModel(_size_model))
    t = tsess.ShardingSession(ts_, ttun.PGMBuilder(KEYS), n_shards,
                              grid=grid, overrides=OVR,
                              size_model=ttun.AnalyticSizeModel(_size_model))
    j.cost._engine = JEngine(j.cost, executor=executor)
    t.cost._engine = PricingEngine(t.cost, executor=executor)
    return j, t


def _point(W, nq=4000, seed=1):
    return W.point(np.random.default_rng(seed).integers(0, N_KEYS, nq),
                   n=N_KEYS)


def _hot(W, center, nq=4000, width=1920, frac=0.92, seed=13):
    rng = np.random.default_rng(seed)
    lo = max(0, center - width // 2)
    hot = rng.integers(lo, min(N_KEYS, lo + width), int(nq * frac))
    cold = rng.integers(0, N_KEYS, nq - hot.shape[0])
    pos = np.concatenate([hot, cold])
    rng.shuffle(pos)
    return W.point(pos, n=N_KEYS)


def _mixed(W, seed=2):
    rng = np.random.default_rng(seed)
    pts = np.sort(rng.integers(0, N_KEYS, 300))
    lo = np.sort(rng.integers(0, N_KEYS - 40, 120))
    hi = lo + rng.integers(0, 40, 120)
    slo = np.sort(rng.integers(0, N_KEYS - 8, 150))
    return W.mixed(W.point(pts, n=N_KEYS), W.range_scan(lo, hi, n=N_KEYS),
                   W.sorted_stream(slo, slo + 7, n=N_KEYS))


def _assert_workloads_equal(got, want):
    assert (got.kind, got.n, got.n_queries) == (want.kind, want.n,
                                                want.n_queries)
    for f in ("positions", "hi_positions"):
        g, w = getattr(got, f), getattr(want, f)
        assert (g is None) == (w is None)
        if g is not None:
            np.testing.assert_array_equal(g, w)
    for g, w in zip(got.parts, want.parts, strict=True):
        _assert_workloads_equal(g, w)


# ---------------------------------------------------------------------------
# Fleet description and routing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("boundaries", [(), (2048, 4096), (2000, 4100, 6001),
                                        (64, 8000)])
def test_route_matches_jax(boundaries):
    """Per-shard local workloads and the overlap accounting, exactly."""
    js_, ts_ = _systems(64 * 1024)
    jf = jsys.ShardedSystem(js_, N_KEYS, boundaries)
    tf = tsys.ShardedSystem(ts_, N_KEYS, boundaries)
    assert tf.replicated_cuts == jf.replicated_cuts
    assert tf.boundary_pages == jf.boundary_pages
    for g, w in zip(tf.shards, jf.shards, strict=True):
        assert (g.lo_rank, g.hi_rank, g.page_lo, g.n_local, g.num_pages) \
            == (w.lo_rank, w.hi_rank, w.page_lo, w.n_local, w.num_pages)
    for tw, jw in ((_mixed(Workload), _mixed(JW)),
                   (_point(Workload), _point(JW))):
        tl, tstats = troute.route(tw, tf)
        jl, jstats = jroute.route(jw, jf)
        assert (tstats.boundary_splits, tstats.boundary_page_overlap) \
            == (jstats.boundary_splits, jstats.boundary_page_overlap)
        for g, w in zip(tl, jl, strict=True):
            _assert_workloads_equal(g, w)


def test_boundary_candidates_match_jax():
    for tw, jw in ((_point(Workload), _point(JW)),
                   (_hot(Workload, 960), _hot(JW, 960)),
                   (_mixed(Workload), _mixed(JW))):
        for s in (2, 4):
            assert troute.boundary_candidates(tw, N_KEYS, s) \
                == jroute.boundary_candidates(jw, N_KEYS, s)
            assert troute.quantile_boundaries(tw, N_KEYS, s) \
                == jroute.quantile_boundaries(jw, N_KEYS, s)
    assert tsys.even_boundaries(N_KEYS, 4) == jsys.even_boundaries(N_KEYS, 4)


def test_sharded_system_validation_matches_jax():
    js_, ts_ = _systems(64 * 1024)
    for bad in ((4096, 2048), (0,), (N_KEYS,)):
        with pytest.raises(ValueError):
            jsys.ShardedSystem(js_, N_KEYS, bad)
        with pytest.raises(ValueError):
            tsys.ShardedSystem(ts_, N_KEYS, bad)
    with pytest.raises(ValueError):
        tsess.ShardingSession(ts_, ttun.PGMBuilder(KEYS), 4, grid=3)
    t = _sessions(2, grid=4)[1]
    with pytest.raises(ValueError):
        t.solve(_point(Workload, 500), [(100, 200)])       # wrong cut count
    with pytest.raises(ValueError, match="uniform-eps"):
        tsess.ShardingSession(ts_, ttun.RMIBuilder(KEYS), 2, grid=4,
                              overrides={"branch": (64,)}).solve(
            _point(Workload, 500))


# ---------------------------------------------------------------------------
# The joint solve and rebalance
# ---------------------------------------------------------------------------

def _assert_plans_equal(got, want):
    assert (got.boundaries, got.fractions, got.total_queries,
            got.cells_solved, got.boundaries_searched) \
        == (want.boundaries, want.fractions, want.total_queries,
            want.cells_solved, want.boundaries_searched)
    assert got.shard_masses == want.shard_masses
    assert [s.knob for s in got.skipped] == [s.knob for s in want.skipped]
    for g, w in zip(got.shards, want.shards, strict=True):
        assert (g.index, g.point, g.knob, g.fraction, g.capacity_pages,
                g.n_queries) == (w.index, w.point, w.knob, w.fraction,
                                 w.capacity_pages, w.n_queries)
        assert g.est_io == pytest.approx(w.est_io, rel=IO_RTOL)
        assert (g.tune is None) == (w.tune is None)
        if w.tune is not None:
            assert (g.tune.best_knob, g.tune.split) \
                == (w.tune.best_knob, w.tune.split)
            for kn, cells in w.tune.table.items():
                for a, b in zip(g.tune.table[kn], cells, strict=True):
                    assert a.capacity_pages == b.capacity_pages
                    assert abs(a.hit_rate - b.hit_rate) < H_ATOL
    for f in ("fleet_io", "io_per_query"):
        assert getattr(got, f) == pytest.approx(getattr(want, f),
                                                rel=IO_RTOL), f
    np.testing.assert_allclose(got.boundary_totals, want.boundary_totals,
                               rtol=IO_RTOL)


@pytest.mark.parametrize("executor", EXECUTORS)
@pytest.mark.parametrize("policy", POLICIES)
def test_solve_matches_jax(policy, executor):
    """A 4-shard fleet under a hot slab: JAX's boundaries, shares, knobs
    and capacities from ONE grouped profile pass and ONE engine call."""
    j, t = _sessions(policy=policy, executor=executor)
    calls = {"grouped": 0}
    real = t.cost.grid_profiles_grouped

    def grouped(*a, **k):
        calls["grouped"] += 1
        return real(*a, **k)

    t.cost.grid_profiles_grouped = grouped
    got = t.solve(_hot(Workload, 600))
    want = j.solve(_hot(JW, 600))
    _assert_plans_equal(got, want)
    assert calls["grouped"] == 1 and t.cost.engine.calls == 1
    assert set(t.cost.engine._instances) == {executor}
    assert got.cells_solved > len(got.boundaries_searched)
    even = t.solve(_hot(Workload, 600), [tsys.even_boundaries(N_KEYS, 4)])
    assert got.io_per_query < even.io_per_query
    _assert_plans_equal(even, j.solve(_hot(JW, 600),
                                      [jsys.even_boundaries(N_KEYS, 4)]))


def _assert_rebalance_equal(got, want):
    assert (got.hot_shard, got.switched, got.from_boundaries,
            got.to_boundaries) == (want.hot_shard, want.switched,
                                   want.from_boundaries, want.to_boundaries)
    np.testing.assert_allclose(got.shard_masses, want.shard_masses,
                               rtol=1e-12)
    assert got.tv == pytest.approx(want.tv, rel=1e-12)
    for f in ("io_current", "io_candidate", "move_io", "predicted_savings"):
        assert getattr(got, f) == pytest.approx(getattr(want, f),
                                                rel=IO_RTOL, abs=1e-12), f
    _assert_plans_equal(got.plan, want.plan)


@pytest.mark.parametrize("policy", POLICIES)
def test_rebalance_matches_jax(policy):
    """Balanced plan, then a hot slab in shard 0: the same move, gate
    verdict and move I/O as JAX, and a refusal under a tiny horizon."""
    j, t = _sessions(policy=policy, executor="device")
    tplan, jplan = t.solve(_point(Workload)), j.solve(_point(JW))
    _assert_plans_equal(tplan, jplan)
    for horizon in (5e7, 1.0):
        got = t.rebalance(_hot(Workload, 960), tplan,
                          horizon_queries=horizon)
        want = j.rebalance(_hot(JW, 960), jplan, horizon_queries=horizon)
        _assert_rebalance_equal(got, want)
        assert got.hot_shard == 0
    stay = t.rebalance(_hot(Workload, 960), tplan, horizon_queries=5e7,
                       boundary_candidates_=[tplan.boundaries])
    assert not stay.switched and stay.move_io == 0.0


def test_rebalance_from_sketch_summary_matches_jax():
    j, t = _sessions()
    tplan, jplan = t.solve(_point(Workload)), j.solve(_point(JW))
    pages = _hot(JW, 960).positions // GEOM_KW["c_ipp"]
    num_pages = -(-N_KEYS // GEOM_KW["c_ipp"])
    bins = np.minimum(pages * 32 // num_pages, 31)
    summary = {"page_pop": np.bincount(bins, minlength=32).astype(float),
               "width": np.zeros(24), "op_mix": np.asarray([1.0, 0, 0])}
    got = t.rebalance(_hot(Workload, 960), tplan, horizon_queries=5e7,
                      summary=summary)
    want = j.rebalance(_hot(JW, 960), jplan, horizon_queries=5e7,
                       summary=summary)
    _assert_rebalance_equal(got, want)
    assert abs(sum(got.shard_masses) - 1.0) < 1e-9


def test_shard_page_masses_matches_jax():
    rng = np.random.default_rng(3)
    for page_bins, num_pages in ((32, 64), (32, 128), (16, 1000)):
        summary = {"page_pop": rng.integers(0, 9, page_bins).astype(float)}
        for cuts in ((10, 40), (1,), (num_pages - 1,), ()):
            assert tmasses(summary, cuts, num_pages) \
                == jmasses(summary, cuts, num_pages)


@pytest.mark.parametrize("policy", POLICIES)
def test_one_shard_fleet_equals_tuning_session(policy):
    """A 1-shard fleet IS the single-node tuner, in the port as in JAX."""
    js_, ts_ = _systems(32 * 1024, policy)
    size = ttun.AnalyticSizeModel(_size_model)
    plan = tsess.ShardingSession(ts_, ttun.PGMBuilder(KEYS), 1, grid=1,
                                 overrides=OVR, size_model=size).solve(
        _point(Workload, 2500, seed=7))
    ref = ttun.TuningSession(ts_).tune(ttun.PGMBuilder(KEYS),
                                       _point(Workload, 2500, seed=7),
                                       overrides=OVR, size_model=size)
    sp = plan.shards[0]
    assert plan.boundaries == () and sp.knob == ref.best_knob
    assert sp.capacity_pages == ref.capacity_pages
    assert sp.est_io == pytest.approx(ref.est_io, abs=1e-9)
    assert plan.io_per_query == pytest.approx(ref.est_io, abs=1e-9)


def test_grid_profiles_grouped_matches_jax():
    """Grouped profiles (zero-padded to the widest group) equal JAX's, and
    solving them equals JAX's solve."""
    js_, ts_ = _systems(64 * 1024)
    jc = [JCand(knob=e, size_bytes=4096.0, eps=e) for e in (4, 64)]
    tc = [GridCandidate(knob=e, size_bytes=4096.0, eps=e) for e in (4, 64)]
    half = np.random.default_rng(22).integers(0, N_KEYS // 2, 700)
    want = JCost(js_).grid_profiles_grouped(
        [("a", jc, _point(JW, 800, 21)), ("b", jc,
                                          JW.point(half, n=N_KEYS // 2))])
    tcost = CostSession(ts_)
    got = tcost.grid_profiles_grouped(
        [("a", tc, _point(Workload, 800, 21)),
         ("b", tc, Workload.point(half, n=N_KEYS // 2))])
    assert got.knobs == want.knobs and got.n_queries == want.n_queries
    cj = np.asarray(want.counts, np.float64)
    assert got.counts.shape == cj.shape
    assert np.max(np.abs(got.counts.double().numpy() - cj)) \
        / max(1.0, cj.max()) < H_ATOL
    np.testing.assert_array_equal(got.caps, want.caps)
    caps, rows = np.asarray([5, 9] * 2), np.arange(4)
    h_t, nd_t = tcost.solve_profiles(got, caps, rows=rows)
    h_j, nd_j = JCost(js_).solve_profiles(want, caps, rows=rows)
    np.testing.assert_allclose(h_t, np.asarray(h_j), rtol=0, atol=H_ATOL)
    np.testing.assert_array_equal(nd_t, np.asarray(nd_j))


# ---------------------------------------------------------------------------
# The benchmark twin
# ---------------------------------------------------------------------------

def test_bench_sharding_smoke_gates():
    """``--smoke`` on the CPU: solved boundaries >= 1.15x the even split
    under lru, fifo and lfu."""
    with redirect_stdout(io.StringIO()):
        rec = bench_sharding.run(smoke=True, torch_device="cpu")
    assert rec["gates"] == {f"solved_1.15x_vs_even_{p}": True
                            for p in POLICIES}
    for p in POLICIES:
        assert rec["policies"][p]["even_over_solved"] >= 1.15
