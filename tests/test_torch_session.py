"""The port's profile -> price -> tune path vs the JAX reference (CPU).

Every session runs with ``torch_device="cpu"``, so the DeviceExecutor and
the device profile executor take their kernels' plain torch versions; the
JAX side runs its Pallas kernels in interpret mode.  Bounds are the ones
tests/test_engine.py pins between the JAX package's own two paths: hit
rates <= 2e-6, distinct pages exact, winners equal up to objective ties at
rtol 1e-5.
"""
import numpy as np
import pytest
import torch

from repro.core.cam import CamGeometry as JGeom
from repro.core.session import CostSession as JCost
from repro.core.session import GridCandidate as JCand
from repro.core.session import System as JSystem
from repro.core.workload import Workload as JWorkload
from repro.data.datasets import make_dataset
from repro.data.workloads import WorkloadSpec, point_workload, range_workload
from repro.engine import PriceTable as JTable
from repro.engine import PricingEngine as JEngine
from repro.index import adapters as jad
from repro.tuning import fit as jfit
from repro.tuning import session as jtune
from repro_torch import convert
from repro_torch.core.cam import CamGeometry
from repro_torch.core.session import (CostSession, GridCandidate,
                                      GridProfiles, SortedScanPart, System)
from repro_torch.core.workload import Workload
from repro_torch.engine import (DeviceExecutor, HostExecutor, PriceTable,
                                PricingEngine)
from repro_torch.index import adapters as tad
from repro_torch.tuning import fit as tfit
from repro_torch.tuning import session as ttune

GEOM, JGEOM = CamGeometry(), JGeom()
#: 64 buffer pages over a 196-page key file: the IRM steady state, not the
#: compulsory regime, so hit rates are far from 1 and errors are visible.
BUDGET = 256 << 10
POLICIES = ("lru", "fifo", "lfu")
KINDS = ("point", "range", "sorted", "mixed")
EPS_GRID = (8, 16, 32, 64)
SPLITS = (0.25, 0.5, 0.75)


def _system(policy, budget=BUDGET):
    return System(GEOM, budget, policy, torch_device="cpu")


@pytest.fixture(scope="module")
def world():
    keys = make_dataset("books", 50_000, seed=1)
    n = len(keys)
    qk, qpos = point_workload(keys, 5_000, WorkloadSpec("w4", seed=3))
    _, _, rlop, rhip = range_workload(keys, 2_000, WorkloadSpec("w1", seed=5),
                                      64)
    slo, shi = np.sort(rlop), np.sort(rhip)

    def wls(W):
        return {
            "point": W.point(qpos, n=n, query_keys=qk),
            "range": W.range_scan(rlop, rhip, n=n),
            "sorted": W.sorted_stream(slo, shi, n=n),
            "mixed": W.mixed(W.point(qpos, n=n), W.sorted_stream(slo, shi, n=n),
                             W.update(qpos[::7], n=n)),
        }
    return keys, wls(JWorkload), wls(Workload)


def _cands(mod=None):
    cls = JCand if mod == "jax" else GridCandidate
    return [cls(eps, 4096.0, eps=eps) for eps in EPS_GRID]


def _tables(jsess, tsess, jwl, twl, cands_j=None, cands_t=None):
    pj = jsess.grid_profiles(cands_j or _cands("jax"), jwl)
    pt = tsess.grid_profiles(cands_t or _cands(), twl)
    kw = dict(splits=SPLITS, budget_bytes=float(BUDGET),
              page_bytes=GEOM.page_bytes)
    return (pj, pt, JTable.from_profiles(pj, {k: {} for k in pj.knobs}, **kw),
            PriceTable.from_profiles(pt, {k: {} for k in pt.knobs}, **kw))


def _assert_solutions(ref, got, exact_distinct=True):
    assert np.max(np.abs(ref.hit_rates - got.hit_rates)) < 2e-6
    if exact_distinct:
        assert np.array_equal(ref.distinct, got.distinct)
    assert np.isclose(ref.objective[got.best_cell],
                      ref.objective[ref.best_cell], rtol=1e-5, atol=1e-12)


# ---------------------------------------------------------------------------
# CostSession: estimate, estimate_grid, grid_profiles, solve_profiles
# ---------------------------------------------------------------------------

_FAMILIES = {
    "pgm": (jad.PGMAdapter, tad.PGMAdapter, 64),
    "rmi": (jad.RMIAdapter, tad.RMIAdapter, 1024),
    "radixspline": (jad.RadixSplineAdapter, tad.RadixSplineAdapter, 64),
}


@pytest.mark.parametrize("family", sorted(_FAMILIES))
@pytest.mark.parametrize("policy", POLICIES)
def test_estimate_matches_jax(world, family, policy):
    keys, jw, tw = world
    jcls, tcls, knob = _FAMILIES[family]
    for kind in ("point", "sorted") if family == "rmi" else KINDS:
        ej = JCost(JSystem(JGEOM, BUDGET, policy)).estimate(
            jcls.build(keys, knob), jw[kind])
        et = CostSession(_system(policy)).estimate(tcls.build(keys, knob),
                                                   tw[kind])
        assert abs(ej.hit_rate - et.hit_rate) < 2e-6, kind
        assert ej.distinct_pages == et.distinct_pages, kind
        assert ej.capacity_pages == et.capacity_pages
        assert ej.policy == et.policy
        assert abs(ej.io_per_query - et.io_per_query) <= 2e-6 * ej.dac


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("kind", KINDS)
def test_estimate_grid_and_profiles_match_jax(world, policy, kind):
    _, jw, tw = world
    jsess = JCost(JSystem(JGEOM, BUDGET, policy))
    tsess = CostSession(_system(policy))
    rj = jsess.estimate_grid(_cands("jax"), jw[kind])
    rt = tsess.estimate_grid(_cands(), tw[kind])
    assert set(rj.estimates) == set(rt.estimates)
    for kn, ej in rj.estimates.items():
        et = rt.estimates[kn]
        assert abs(ej.hit_rate - et.hit_rate) < 2e-6, kn
        assert ej.distinct_pages == et.distinct_pages
        assert ej.total_refs == pytest.approx(et.total_refs, rel=2e-6)
    assert np.isclose(rj.estimates[rt.best_knob].io_per_query,
                      rj.best.io_per_query, rtol=1e-5)
    if kind == "sorted":
        return
    pj = jsess.grid_profiles(_cands("jax"), jw[kind])
    pt = tsess.grid_profiles(_cands(), tw[kind])
    assert isinstance(pt.counts, torch.Tensor) and pt.counts.dtype == \
        torch.float32
    cj = np.asarray(pj.counts, np.float64)
    scale = max(1.0, float(cj.max()))
    assert np.max(np.abs(cj - pt.counts.double().numpy())) / scale < 2e-6
    assert np.allclose(pj.totals, pt.totals, rtol=2e-6)
    assert np.allclose(pj.dacs, pt.dacs, rtol=1e-7)
    assert np.array_equal(pj.caps, pt.caps)
    caps = np.concatenate([pt.caps, pt.caps // 3])
    rows = np.concatenate([np.arange(len(pt.knobs))] * 2)
    hj, nj = jsess.solve_profiles(pj, caps, rows=rows)
    ht, nt = tsess.solve_profiles(pt, caps, rows=rows)
    assert np.max(np.abs(hj - ht)) < 2e-6
    assert np.array_equal(nj, nt)


# ---------------------------------------------------------------------------
# Executors: the port's host and device vs JAX's host and device
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("kind", ("point", "range", "mixed"))
def test_executors_match_jax(world, policy, kind):
    _, jw, tw = world
    jsess = JCost(JSystem(JGEOM, BUDGET, policy))
    tsess = CostSession(_system(policy))
    _, _, tab_j, tab_t = _tables(jsess, tsess, jw[kind], tw[kind])
    assert len(tab_t) > len(EPS_GRID)
    jeng, teng = JEngine(jsess), PricingEngine(tsess)
    ref = jeng.price(tab_j, executor="host")
    host = teng.price(tab_t, executor="host")
    dev = teng.price(tab_t, executor="device")
    assert (host.executor, dev.executor) == ("host", "device")
    _assert_solutions(ref, host)
    _assert_solutions(ref, dev)
    _assert_solutions(host, dev)
    if kind == "mixed":      # sorted + write columns through the Pallas path
        _assert_solutions(jeng.price(tab_j, executor="device"), dev)


def _carried(pj):
    """A JAX GridProfiles carried across through ``repro_torch.convert``."""
    return convert.grid_profiles(
        knobs=pj.knobs, counts=np.asarray(pj.counts), totals=pj.totals,
        dacs=pj.dacs, sizes=pj.sizes, caps=pj.caps, scale=pj.scale,
        n_queries=pj.n_queries,
        sparts=[None if sp is None else dict(
            total_refs=sp.total_refs, distinct_pages=sp.distinct_pages,
            min_capacity=sp.min_capacity, pinned_retouches=sp.pinned_retouches,
            coverage=None if sp.coverage is None else np.asarray(sp.coverage))
            for sp in pj.sparts],
        wparts=[None if wp is None else dict(counts=np.asarray(wp.counts),
                                             total_refs=wp.total_refs)
                for wp in pj.wparts],
        skipped=[(sk.knob, sk.reason) for sk in pj.skipped], device="cpu")


@pytest.mark.parametrize("policy", POLICIES)
def test_same_profiles_price_alike_on_both_engines(world, policy):
    """JAX-built profiles carried across: the pricing engines alone, on
    identical histograms, sorted and write parts included."""
    _, jw, _ = world
    jsess = JCost(JSystem(JGEOM, BUDGET, policy))
    pj = jsess.grid_profiles(_cands("jax"), jw["mixed"])
    pt = _carried(pj)
    assert pt.counts.device.type == "cpu" and pt.wparts and pt.sparts[0]
    kw = dict(splits=SPLITS, budget_bytes=float(BUDGET),
              page_bytes=GEOM.page_bytes)
    tab_j = JTable.from_profiles(pj, {k: {} for k in pj.knobs}, **kw)
    tab_t = PriceTable.from_profiles(pt, {k: {} for k in pt.knobs}, **kw)
    assert np.array_equal(tab_j.caps, tab_t.caps)
    teng = PricingEngine(CostSession(_system(policy)))
    for ex_j in ("host", "device"):
        ref = JEngine(jsess).price(tab_j, executor=ex_j)
        for ex_t in ("host", "device"):
            _assert_solutions(ref, teng.price(tab_t, executor=ex_t))


@pytest.mark.parametrize("executor", ("host", "device"))
def test_cross_policies_and_grouped_profiles(world, executor):
    _, jw, tw = world
    jsess = JCost(JSystem(JGEOM, BUDGET, "lru"))
    tsess = CostSession(_system("lru"))
    _, _, tab_j, tab_t = _tables(jsess, tsess, jw["mixed"], tw["mixed"])
    ref = JEngine(jsess).price(tab_j.cross_policies(POLICIES),
                               executor="host")
    got = PricingEngine(tsess).price(tab_t.cross_policies(POLICIES),
                                     executor=executor)
    _assert_solutions(ref, got)
    gj = jsess.grid_profiles_grouped([("s0", _cands("jax"), jw["point"]),
                                      ("s1", _cands("jax")[:2], jw["mixed"])])
    gt = tsess.grid_profiles_grouped([("s0", _cands(), tw["point"]),
                                      ("s1", _cands()[:2], tw["mixed"])])
    assert gj.knobs == gt.knobs
    kw = dict(splits=SPLITS, budget_bytes=float(BUDGET),
              page_bytes=GEOM.page_bytes)
    _assert_solutions(
        JEngine(jsess).price(JTable.from_profiles(
            gj, {k: {} for k in gj.knobs}, **kw), executor="host"),
        PricingEngine(tsess).price(PriceTable.from_profiles(
            gt, {k: {} for k in gt.knobs}, **kw), executor=executor))


@pytest.mark.parametrize("policy", POLICIES)
def test_rmi_branch_grid_profiles_on_both_profile_executors(world, policy):
    """RMI branch grids profile through the mixed-eps pass: the port's host
    bincount kernel and its device path (the plain profile_grid version on
    CPU tensors) both match the JAX host kernel, and price identically."""
    keys, jw, tw = world
    jb, tb = jtune.RMIBuilder(keys), ttune.RMIBuilder(keys)
    jc = [jb.candidate({"branch": b}, 0.0) for b in (64, 256, 1024)]
    tc = [tb.candidate({"branch": b}, 0.0) for b in (64, 256, 1024)]
    jsess = JCost(JSystem(JGEOM, BUDGET, policy))
    tsess = CostSession(_system(policy))
    pj = jsess.grid_profiles(jc, jw["point"], executor="host")
    cj = np.asarray(pj.counts, np.float64)
    scale = max(1.0, float(cj.max()))
    sols = []
    for ex in ("host", "device"):
        pt = tsess.grid_profiles(tc, tw["point"], executor=ex)
        assert pt.knobs == pj.knobs
        assert np.max(np.abs(cj - pt.counts.double().numpy())) / scale < 2e-6
        assert np.max(np.abs(pj.totals - pt.totals)
                      / np.maximum(pj.totals, 1.0)) < 2e-6
        tab = PriceTable.from_profiles(
            pt, {k: {} for k in pt.knobs}, splits=SPLITS,
            budget_bytes=float(BUDGET), page_bytes=GEOM.page_bytes)
        sols.append(PricingEngine(tsess).price(tab, executor=ex))
    _assert_solutions(sols[0], sols[1])


@pytest.mark.parametrize("policy", POLICIES)
def test_large_capacity_thrash_flip_exact_on_both_executors(policy):
    """A 2^24-page buffer one page below a 2^24 + 1 Thm III.1 premise
    thrashes on both executors; float32 capacities would round them equal."""
    cov = torch.zeros(32)
    cov[:16] = 2.0                                        # R=32, N=16
    sp = SortedScanPart(32.0, 16.0, 2**24 + 1, cov, 0.0)
    prof = GridProfiles(
        knobs=("k",), counts=torch.zeros((1, 32)), totals=np.zeros(1),
        dacs=np.ones(1), sizes=np.zeros(1), caps=np.array([2**25]),
        sparts=(sp,), skipped=(), scale=1.0, n_queries=32)
    tab = PriceTable.from_cells(prof, [("k", 0, np.array([2**24,
                                                          2**24 + 1]))])
    eng = PricingEngine(CostSession(_system(policy)))
    for ex in ("host", "device"):
        sol = eng.price(tab, executor=ex)
        assert sol.hit_rates[0] == 0.0, ex                # thrash
        assert sol.hit_rates[1] == pytest.approx(0.5), ex
        assert sol.best_cell == 1, ex


# ---------------------------------------------------------------------------
# Dispatch and structure
# ---------------------------------------------------------------------------

def test_dispatch_precedence_and_cpu_auto_rule(world, engine_executor):
    _, _, tw = world
    sess = CostSession(_system("lru"))
    tab = PriceTable.max_capacity(sess.grid_profiles(_cands(), tw["point"]),
                                  float(BUDGET))
    engine_executor(None)
    assert PricingEngine(sess).price(tab).executor == "host"      # CPU auto
    assert PricingEngine(sess, executor="device").price(tab).executor == \
        "device"
    engine_executor("device")                                     # env wins
    eng = PricingEngine(sess, executor="host")
    assert eng.price(tab).executor == "device"
    assert eng.price(tab, executor="host").executor == "host"     # arg wins
    assert eng.price(tab, executor=HostExecutor()).executor == "host"
    assert eng.price(tab, executor=DeviceExecutor()).executor == "device"
    with pytest.raises(ValueError):
        eng.price(tab, executor="gpu-ish")


def test_profile_dispatch_precedence(world, engine_executor, monkeypatch):
    from repro_torch.core import page_ref as _pr
    from repro_torch.kernels import profile_grid as _pg

    keys, _, tw = world
    tb = ttune.RMIBuilder(keys)
    cands = [tb.candidate({"branch": b}, 0.0) for b in (64, 256)]
    sess = CostSession(_system("lru"))
    calls = {"host": 0, "device": 0}

    def spy(side, real):
        def wrapped(*a, **k):
            calls[side] += 1
            return real(*a, **k)
        return wrapped

    monkeypatch.setattr(_pr, "point_page_refs_mixed_eps_grid",
                        spy("host", _pr.point_page_refs_mixed_eps_grid))
    monkeypatch.setattr(_pg, "point_page_refs_mixed_eps_grid",
                        spy("device", _pg.point_page_refs_mixed_eps_grid))
    engine_executor("device")
    sess.grid_profiles(cands, tw["point"])
    assert calls == {"host": 0, "device": 1}
    engine_executor("host")
    sess.grid_profiles(cands, tw["point"], executor="device")
    assert calls == {"host": 0, "device": 2}
    sess.grid_profiles(cands, tw["point"])
    assert calls == {"host": 1, "device": 2}
    engine_executor(None)                   # auto on a CPU session: host
    sess.grid_profiles(cands, tw["point"])
    assert calls == {"host": 2, "device": 2}
    with pytest.raises(ValueError, match="executor"):
        sess.grid_profiles(cands, tw["point"], executor="gpu-ish")


def test_estimate_grid_and_tune_are_one_engine_call(world):
    keys, _, tw = world
    sess = CostSession(_system("lru"))
    assert sess.engine.calls == 0
    sess.estimate_grid(_cands(), tw["point"])
    sess.estimate_grid(_cands(), tw["mixed"])
    assert sess.engine.calls == 2
    ts = ttune.TuningSession(_system("lru"),
                             splits=tuple(i / 8 for i in range(1, 8)))
    res = ts.tune(ttune.PGMBuilder(keys), tw["point"],
                  overrides={"eps": EPS_GRID})
    assert ts.cost.engine.calls == 1 and res.batched_solves == 1


# ---------------------------------------------------------------------------
# Tuning and fitting
# ---------------------------------------------------------------------------

TUNE_BUDGET = 192 << 10


def _shared_size_models(family, keys):
    """PGM sizes come from a float32 Adam fit whose result is sensitive at
    the ~1e-3 level (see the fit test below): both tuners price the SAME
    fitted curve so the comparison isolates the profile -> price path."""
    if family != "pgm":
        return None, None
    fitted = jtune.builder_for(family, keys).size_model()
    fitted(eps=64)                                        # fit once
    return fitted, ttune.AnalyticSizeModel(lambda eps: fitted(eps=eps))


@pytest.mark.parametrize("family", ("pgm", "rmi"))
@pytest.mark.parametrize("policies", (None, POLICIES))
def test_tune_matches_jax(world, family, policies, engine_executor):
    keys, jw, tw = world
    sm_j, sm_t = _shared_size_models(family, keys)
    rj = jtune.TuningSession(JSystem(JGEOM, TUNE_BUDGET, "lru")).tune(
        jtune.builder_for(family, keys), jw["point"], policies=policies,
        size_model=sm_j)
    for ex in ("host", "device"):
        engine_executor(ex)
        rt = ttune.TuningSession(_system("lru", TUNE_BUDGET)).tune(
            ttune.builder_for(family, keys), tw["point"], policies=policies,
            size_model=sm_t)
        assert rt.best == rj.best, ex
        assert rt.split == rj.split and rt.capacity_pages == rj.capacity_pages
        assert rt.est_io == pytest.approx(rj.est_io, rel=1e-5), ex
        assert [s.knob for s in rt.skipped] == [s.knob for s in rj.skipped]
        assert set(rt.table) == set(rj.table)


def test_fit_power_law_matches_jax_within_its_own_sensitivity():
    """float32 Adam ends in a gradient-noise regime: the JAX fit itself
    moves by up to ~5e-3 when one sample size moves by one float32 ulp.
    The port must agree with it within twice that spread (and never worse
    than 1e-2) over the dense eps grid."""
    grid = np.asarray(tad.DEFAULT_EPS_GRID, np.float64)
    xs = [16, 64, 256, 1024]
    for ys in ([50_000.0, 9_000.0, 2_500.0, 900.0],
               [8_096.0, 1_296.0, 112.0, 16.0]):
        base = jfit.fit_power_law(xs, ys)
        spread = 0.0
        for i in range(len(ys)):
            nudged = list(ys)
            nudged[i] = float(np.nextafter(np.float32(ys[i]),
                                           np.float32(np.inf)))
            spread = max(spread, float(np.max(
                np.abs(jfit.fit_power_law(xs, nudged)(grid) - base(grid))
                / np.abs(base(grid)))))
        port = tfit.fit_power_law(xs, ys)
        rel = float(np.max(np.abs(port(grid) - base(grid))
                           / np.abs(base(grid))))
        assert rel <= min(max(1e-4, 2.0 * spread), 1e-2), (rel, spread)
    assert np.allclose(tfit.ols(np.eye(3), [1.0, 2.0, 3.0]), [1, 2, 3])


# ---------------------------------------------------------------------------
# The slice end to end
# ---------------------------------------------------------------------------

def test_slice_end_to_end_matches_jax(world, engine_executor):
    """Workload -> adapters -> grid_profiles -> PriceTable -> price -> tune,
    through the port's device executors (plain kernel versions on CPU
    tensors), held against the JAX host path on one world."""
    keys, jw, tw = world
    engine_executor("device")
    tsys = _system("lfu", TUNE_BUDGET)
    jsys = JSystem(JGEOM, TUNE_BUDGET, "lfu")
    ts = ttune.TuningSession(tsys)
    js = jtune.TuningSession(jsys)
    for family in ("pgm", "rmi", "radixspline"):
        tb = ttune.builder_for(family, keys)
        jb = jtune.builder_for(family, keys)
        overrides = {"eps": EPS_GRID} if family != "rmi" else None
        sm_j, sm_t = _shared_size_models(family, keys)
        if family == "radixspline":
            sm_j = jb.size_model()
            sm_t = ttune.AnalyticSizeModel(
                lambda eps, radix_bits: sm_j(eps=eps, radix_bits=radix_bits))
        rt = ts.tune(tb, tw["point"], overrides=overrides, size_model=sm_t)
        engine_executor("host")
        rj = js.tune(jb, jw["point"], overrides=overrides, size_model=sm_j)
        engine_executor("device")
        assert rt.best == rj.best and rt.split == rj.split, family
        assert rt.est_io == pytest.approx(rj.est_io, rel=1e-5), family
        for kn, est in rj.estimates.items():
            assert abs(est.hit_rate - rt.estimates[kn].hit_rate) < 2e-6
    # the mixed workload (sorted + write columns) through estimate_grid
    gt = CostSession(tsys).estimate_grid(_cands(), tw["mixed"])
    gj = JCost(jsys).estimate_grid(_cands("jax"), jw["mixed"])
    for kn, est in gj.estimates.items():
        assert abs(est.hit_rate - gt.estimates[kn].hit_rate) < 2e-6
