"""The port's JoinSession vs the JAX reference (CPU).

Every port session runs with ``torch_device="cpu"``.  Pricing goes once
through the port's HostExecutor and once through ``executor="device"``,
which on CPU tensors runs the ``price_grid`` kernel's plain version
(``price_grid_ref``); the JAX side keeps its own default executor.  Bounds:

* Algorithm 2 segments, thrash flags, capacities and replayed stats
  (physical and logical I/O, matches): exact;
* the integer-valued sorted statistics (R, N, coverage): exact; the
  pinned re-touch count at 2e-6 relative;
* plan costs and cost curves: rtol 1e-5 (the float32 hit-rate bound the
  engine tests pin between the JAX package's own two executors).
"""
import dataclasses

import numpy as np
import pytest

from repro.core.cam import CamGeometry as JGeom
from repro.core.session import System as JSystem
from repro.data.datasets import make_dataset
from repro.data.workloads import WorkloadSpec, join_outer_keys
from repro.index import adapters as jad
from repro.join.session import JoinSession as JJoin
from repro.join.session import curve_price_table as jcurve_table
from repro_torch.core.cam import CamGeometry
from repro_torch.core.session import System
from repro_torch.engine import PricingEngine
from repro_torch.index import adapters as tad
from repro_torch.join.session import STRATEGIES, JoinSession
from repro_torch.join.session import curve_price_table
from repro_torch.kernels import price_grid as tpg

POLICIES = ("lru", "fifo", "lfu")
FAMILIES = ("pgm", "rmi", "radixspline")
EXECUTORS = ("host", "device")
COST_RTOL = 1e-5
PLAN_KW = dict(n_min=128, k_max=4096)
BUDGET = 2 << 20


def _build(mod, family, keys):
    if family == "pgm":
        return mod.PGMAdapter.build(keys, eps=32)
    if family == "rmi":
        return mod.RMIAdapter.build(keys, branch=256)
    return mod.RadixSplineAdapter.build(keys, eps=32)


@pytest.fixture(scope="module")
def world():
    keys = make_dataset("books", 200_000, seed=5)
    outer = join_outer_keys(keys, 15_000, WorkloadSpec("w4", seed=9))
    inners = {f: (_build(jad, f, keys), _build(tad, f, keys))
              for f in FAMILIES}
    return keys, outer, inners, {}


def _sessions(world, family="pgm", policy="lru", executor="host"):
    keys, _, inners, _ = world
    jidx, tidx = inners[family]
    assert tidx.size_bytes == jidx.size_bytes
    budget = BUDGET + tidx.size_bytes
    js = JJoin(jidx, JSystem(JGeom(), budget, policy), inner_keys=keys)
    ts = JoinSession(tidx, System(CamGeometry(), budget, policy,
                                  torch_device="cpu"), inner_keys=keys)
    _pin(ts._cost_session, executor)
    return js, ts


def _pin(cost_session, executor):
    """Pin the port's pricing executor (the JAX side keeps its default)."""
    cost_session._engine = PricingEngine(cost_session, executor=executor)


def _jax_cached(world, key, fn):
    cache = world[3]
    if key not in cache:
        cache[key] = fn()
    return cache[key]


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=COST_RTOL, atol=0,
                               err_msg=what)


def _assert_plan_equal(got, want, what):
    assert got.strategy == want.strategy
    assert [dataclasses.astuple(s) for s in got.segments] \
        == [dataclasses.astuple(s) for s in want.segments], what   # exact
    assert (got.thrash, got.capacity, got.sorted_stream) \
        == (want.thrash, want.capacity, want.sorted_stream), what
    np.testing.assert_array_equal(got.outer_keys, want.outer_keys)
    np.testing.assert_array_equal(got.page_lo, np.asarray(want.page_lo))
    np.testing.assert_array_equal(got.page_hi, np.asarray(want.page_hi))
    _close(got.cost.seconds, want.cost.seconds, what + " seconds")
    _close(got.cost.physical_ios, want.cost.physical_ios, what + " io")
    assert got.cost.logical_refs == want.cost.logical_refs, what


def _assert_stats_equal(got, want, what):
    assert (got.physical_ios, got.logical_refs, got.matches,
            got.n_segments, got.n_range_segments) \
        == (want.physical_ios, want.logical_refs, want.matches,
            want.n_segments, want.n_range_segments), what          # exact
    np.testing.assert_allclose(got.seconds, want.seconds, rtol=1e-12,
                               err_msg=what)


# ---------------------------------------------------------------------------
# plan / execute, every family x policy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("policy", POLICIES)
def test_plans_and_replay_equal_to_jax(world, family, policy):
    js, ts = _sessions(world, family, policy)
    outer = world[1]
    for strategy in STRATEGIES:
        want = js.plan(outer, strategy, **PLAN_KW)
        got = ts.plan(outer, strategy, **PLAN_KW)
        what = f"{family}/{policy}/{strategy}"
        _assert_plan_equal(got, want, what)
        _assert_stats_equal(ts.execute(got), js.execute(want), what)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("capacity", (1, 16, 300))
def test_capped_plans_equal_to_jax(world, policy, capacity):
    """Externally capped capacities (a join-tree slice) take the capped
    CostSession views and the LFU miss scale at that capacity."""
    js, ts = _sessions(world, "pgm", policy)
    outer = world[1]
    for strategy in STRATEGIES:
        want = js.plan(outer, strategy, capacity=capacity, **PLAN_KW)
        got = ts.plan(outer, strategy, capacity=capacity, **PLAN_KW)
        _assert_plan_equal(got, want, f"{policy}/{capacity}/{strategy}")
    assert ts._session_at(capacity).device.type == "cpu"


# ---------------------------------------------------------------------------
# choose: calibrated, same pick as JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("wl", ("w1", "w2"))
def test_choose_picks_the_same_strategy_as_jax(world, policy, wl):
    keys = world[0]
    outer = join_outer_keys(keys, 15_000, WorkloadSpec(wl, seed=9))
    js, ts = _sessions(world, "pgm", policy)
    jp, tp = js.calibrate(), ts.calibrate()
    assert dataclasses.asdict(tp) == dataclasses.asdict(jp)       # exact
    want = js.choose(outer, **PLAN_KW)
    got = ts.choose(outer, **PLAN_KW)
    assert got.strategy == want.strategy
    for s in STRATEGIES:
        _close(got.costs[s].seconds, want.costs[s].seconds, s)
    _assert_stats_equal(ts.execute(got.plan), js.execute(want.plan),
                        got.strategy)


# ---------------------------------------------------------------------------
# cost_curve through both executors
# ---------------------------------------------------------------------------

CAPS = np.array([2, 4, 8, 16, 32, 64, 128, 256, 512])


@pytest.mark.parametrize("executor", EXECUTORS)
@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("policy", POLICIES)
def test_cost_curve_equal_to_jax(world, monkeypatch, executor, family,
                                 policy):
    js, ts = _sessions(world, family, policy, executor)
    outer = world[1]
    launches = []
    real = tpg.price_grid
    monkeypatch.setattr(tpg, "price_grid",
                        lambda *a, **kw: launches.append(1) or real(*a, **kw))
    want = _jax_cached(world, ("curve", family, policy),
                       lambda: js.cost_curve(outer, CAPS, **PLAN_KW))
    got = ts.cost_curve(outer, CAPS, **PLAN_KW)
    np.testing.assert_array_equal(got.capacities, want.capacities)
    assert got.n_probes == want.n_probes
    for s in STRATEGIES:
        _close(got.seconds[s], want.seconds[s], f"{executor} {s} seconds")
        _close(got.physical_ios[s], want.physical_ios[s], f"{executor} {s}")
    eng = ts._cost_session.engine
    assert eng.calls == 1 and set(eng._instances) == {executor}
    assert len(launches) == (1 if executor == "device" else 0)


@pytest.mark.parametrize("policy", POLICIES)
def test_curve_state_sorted_statistics_equal_to_jax(world, policy):
    js, ts = _sessions(world, "pgm", policy)
    outer = world[1]
    jst, tst = js._curve_state(outer), ts._curve_state(outer)
    jsp, tsp = jst.sorted_part, tst.sorted_part
    assert (tsp.total_refs, tsp.distinct_pages, tsp.min_capacity) \
        == (jsp.total_refs, jsp.distinct_pages, jsp.min_capacity)   # exact
    np.testing.assert_array_equal(tsp.coverage.numpy(),
                                  np.asarray(jsp.coverage))         # exact
    np.testing.assert_allclose(tsp.pinned_retouches, jsp.pinned_retouches,
                               rtol=2e-6)
    assert (tst.n, tst.refs, tst.span, tst.min_cap, tst.num_pages) \
        == (jst.n, jst.refs, jst.span, jst.min_cap, jst.num_pages)
    # JAX (x64 off) holds the windows as int32; the port as int64 tensors
    assert ts._windows(tst.page_lo, tst.page_hi)[0].dtype.itemsize == 8
    np.testing.assert_allclose(tst.inlj_prof.counts.numpy(),
                               np.asarray(jst.inlj_prof.counts),
                               rtol=2e-6, atol=2e-6)


def test_curve_price_table_rows_equal_to_jax(world):
    """The zero-histogram sorted row and the INLJ row: same knobs, same
    scalars, counts and coverage equal up to the histogram's float32
    summation order (2e-6)."""
    js, ts = _sessions(world, "rmi", "lfu")
    outer = world[1]
    states_j = [("a", js._curve_state(outer)),
                ("b", js._curve_state(outer[:4000], sample_rate=0.5))]
    states_t = [("a", ts._curve_state(outer)),
                ("b", ts._curve_state(outer[:4000], sample_rate=0.5))]
    caps = np.array([3, 30, 300])
    want = jcurve_table(states_j, caps)
    got = curve_price_table(states_t, caps, device="cpu")
    pj, pt = want.profiles, got.profiles
    assert pt.knobs == pj.knobs
    assert pt.counts.device.type == "cpu"
    np.testing.assert_allclose(pt.counts.numpy(), np.asarray(pj.counts),
                               rtol=2e-6, atol=2e-6)
    sorted_rows = [i for i, kn in enumerate(pt.knobs) if kn[1] == "sorted"]
    assert sorted_rows and all(float(pt.counts[i].abs().sum()) == 0.0
                               and pt.totals[i] == 0.0 for i in sorted_rows)
    np.testing.assert_allclose(pt.totals, pj.totals, rtol=1e-6)
    # E[DAC] of the INLJ rows is a float32 reduction in both packages
    np.testing.assert_allclose(pt.dacs, pj.dacs, rtol=2e-6)
    for spt, spj in zip(pt.sparts, pj.sparts):
        assert (spt is None) == (spj is None)
        if spt is not None:
            np.testing.assert_array_equal(spt.coverage.numpy(),
                                          np.asarray(spj.coverage))
    np.testing.assert_array_equal(got.rows, want.rows)
    np.testing.assert_array_equal(got.caps, want.caps)
    assert got.spans == want.spans

