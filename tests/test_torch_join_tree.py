"""The port's JoinTreeSession and legacy join executors vs JAX (CPU).

A three-level tree (``keys``, ``keys[::2]``, ``keys[::3]``, PGM eps 32)
shares one buffer pool.  The port plans it through its HostExecutor and
through ``executor="device"`` (the ``price_grid`` kernel's plain version on
CPU tensors); the JAX side keeps its own default executor.  Held: the
chosen fractions, per-level strategies and capacities exactly, the
composed predicted seconds and I/O and every level's curve at rtol 1e-5,
and the replayed stats exactly.  The legacy ``executors.*`` entry points
run with ``torch_device="cpu"`` and replay exactly as JAX's do.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core.cam import CamGeometry as JGeom
from repro.core.session import System as JSystem
from repro.data.datasets import make_dataset
from repro.data.workloads import WorkloadSpec, join_outer_keys
from repro.index.adapters import PGMAdapter as JPGM
from repro.index.disk_layout import PageLayout as JLayout
from repro.join import executors as jex
from repro.join.tree import JoinTreeSession as JTree
from repro_torch.core.cam import CamGeometry
from repro_torch.core.session import System
from repro_torch.engine import PricingEngine
from repro_torch.index.adapters import PGMAdapter
from repro_torch.index.disk_layout import PageLayout
from repro_torch.join import executors as tex
from repro_torch.join.hybrid import JoinCostParams
from repro_torch.join.session import STRATEGIES, JoinSession
from repro_torch.join.tree import JoinTreeSession
from repro_torch.kernels import price_grid as tpg

POLICIES = ("lru", "fifo", "lfu")
COST_RTOL = 1e-5
N_BASE = 80_000
N_OUTER = 6_000
GRID = 8
POOL = 1 << 20
PLAN_KW = dict(grid=GRID, n_min=128, k_max=4096)


@pytest.fixture(scope="module")
def world():
    base = make_dataset("books", N_BASE, seed=5)
    inner_keys = [base, base[::2].copy(), base[::3].copy()]
    jad = [JPGM.build(k, eps=32) for k in inner_keys]
    tad = [PGMAdapter.build(k, eps=32) for k in inner_keys]
    outers = {wl: join_outer_keys(base, N_OUTER, WorkloadSpec(wl, seed=9))
              for wl in ("w1", "w2")}
    return base, inner_keys, jad, tad, outers, {}


def _trees(world, policy, executor="host"):
    _, inner_keys, jad, tad, _, _ = world
    idx = sum(a.size_bytes for a in tad)
    assert idx == sum(a.size_bytes for a in jad)
    jt = JTree(jad, JSystem(JGeom(), POOL + idx, policy), inner_keys)
    tt = JoinTreeSession(tad, System(CamGeometry(), POOL + idx, policy,
                                     torch_device="cpu"), inner_keys)
    tt._cost_session._engine = PricingEngine(tt._cost_session,
                                             executor=executor)
    return jt, tt


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=COST_RTOL, atol=0,
                               err_msg=what)


def _stats_tuple(st):
    return (st.strategy, st.physical_ios, st.logical_refs, st.matches,
            st.n_segments, st.n_range_segments)


# ---------------------------------------------------------------------------
# plan + execute against JAX, through both executors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("executor", ("host", "device"))
@pytest.mark.parametrize("objective", ("seconds", "io"))
@pytest.mark.parametrize("policy", POLICIES)
def test_tree_plan_and_execute_equal_to_jax(world, monkeypatch, executor,
                                            objective, policy):
    outer = world[4]["w2"]
    jt, tt = _trees(world, policy, executor)
    cache = world[5]
    key = (policy, objective)
    if key not in cache:
        jplan = jt.plan(outer, objective=objective, **PLAN_KW)
        cache[key] = (jplan, jt.execute(jplan))
    want, want_stats = cache[key]
    launches = []
    real = tpg.price_grid
    monkeypatch.setattr(tpg, "price_grid",
                        lambda *a, **kw: launches.append(1) or real(*a, **kw))
    got = tt.plan(outer, objective=objective, **PLAN_KW)
    assert len(launches) == (1 if executor == "device" else 0)
    assert tt._cost_session.engine.calls == 1
    assert got.fractions == want.fractions
    assert got.strategies == want.strategies
    assert got.capacities == want.capacities
    assert got.objective == want.objective
    _close(got.cost.seconds, want.cost.seconds, "tree seconds")
    _close(got.cost.physical_ios, want.cost.physical_ios, "tree io")
    for lvl, (cg, cw) in enumerate(zip(got.curves, want.curves)):
        np.testing.assert_array_equal(cg.capacities, cw.capacities)
        for s in STRATEGIES:
            _close(cg.seconds[s], cw.seconds[s], f"level {lvl} {s} seconds")
            _close(cg.physical_ios[s], cw.physical_ios[s],
                   f"level {lvl} {s} io")
    for pg, pw in zip(got.levels, want.levels):
        assert [dataclasses.astuple(s) for s in pg.segments] \
            == [dataclasses.astuple(s) for s in pw.segments]        # exact
    stats = tt.execute(got)
    assert (stats.physical_ios, stats.logical_refs, stats.matches) \
        == (want_stats.physical_ios, want_stats.logical_refs,
            want_stats.matches)                                     # exact
    assert [_stats_tuple(s) for s in stats.per_level] \
        == [_stats_tuple(s) for s in want_stats.per_level]
    np.testing.assert_allclose(stats.seconds, want_stats.seconds, rtol=1e-12)


def test_probe_streams_and_calibration_equal_to_jax(world):
    outer = world[4]["w1"]
    jt, tt = _trees(world, "lru")
    for a, b in zip(tt.probe_streams(outer), jt.probe_streams(outer)):
        np.testing.assert_array_equal(a, b)                         # exact
    assert (tt.pool_pages, tt.pool_bytes) == (jt.pool_pages, jt.pool_bytes)
    tp, jp = tt.calibrate(), jt.calibrate()
    assert dataclasses.asdict(tp) == dataclasses.asdict(jp)         # exact
    assert all(s.params is tp for s in tt.sessions)
    assert all(s._cost_session.device.type == "cpu" for s in tt.sessions)


# ---------------------------------------------------------------------------
# The monotone-curve property (tests/test_join_tree.py), on the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("executor", ("host", "device"))
@pytest.mark.parametrize("policy", POLICIES)
def test_miss_curves_monotone_in_capacity(world, policy, executor):
    base, _, _, tad, outers, _ = world
    system = System(CamGeometry(), POOL + tad[0].size_bytes, policy,
                    torch_device="cpu")
    s = JoinSession(tad[0], system, inner_keys=base)
    s._cost_session._engine = PricingEngine(s._cost_session,
                                            executor=executor)
    caps = np.array([2, 4, 8, 16, 32, 64, 128, 256])
    curve = s.cost_curve(outers["w2"], caps, n_min=128, k_max=4096)
    for strategy in STRATEGIES:
        ios = curve.physical_ios[strategy]
        assert (np.diff(ios) <= 1e-6).all(), (policy, strategy, ios)
        secs = curve.seconds[strategy]
        assert (np.diff(secs) <= 1e-9).all(), (policy, strategy, secs)


# ---------------------------------------------------------------------------
# The legacy loose-argument executors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ("inlj", "point_only", "range_only",
                                  "hybrid_join"))
@pytest.mark.parametrize("capacity", (4, 120))
def test_legacy_executors_equal_to_jax(world, name, capacity):
    base, _, jad, tad, outers, _ = world
    outer = outers["w1"]
    kw = dict(n_min=128) if name == "hybrid_join" else {}
    got = getattr(tex, name)(tad[0], base, outer, PageLayout(), capacity,
                             "lru", torch_device="cpu", **kw)
    want = getattr(jex, name)(jad[0], base, outer, JLayout(), capacity,
                              "lru", **kw)
    assert _stats_tuple(got) == _stats_tuple(want)                  # exact
    np.testing.assert_allclose(got.seconds, want.seconds, rtol=1e-12)


def test_session_for_passes_the_device_through(world):
    base, _, _, tad, _, _ = world
    s = tex.session_for(tad[0], base, PageLayout(), 64, "lfu",
                        params=JoinCostParams(), torch_device="cpu")
    assert s._cost_session.device.type == "cpu"
    assert s.capacity == 64 and s.system.policy == "lfu"


def test_join_entry_points_default_to_the_card(world, monkeypatch):
    """Without CUDA every join entry point that is not asked for the CPU
    raises; none falls back."""
    base, inner_keys, _, tad, outers, _ = world
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tex.session_for(tad[0], base, PageLayout(), 64)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tex.inlj(tad[0], base, outers["w1"], PageLayout(), 64)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        JoinTreeSession(tad, System(memory_budget_bytes=8 << 20),
                        inner_keys)
