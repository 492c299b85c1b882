"""The port's write path (delta staging, merge schedulers, WriteSession)
and its updatable index adapters against the JAX reference, on the CPU.

Both packages get the same keys and events (one numpy seed each).  Port
sessions run with ``torch_device="cpu"``; their pricing executor is pinned
per session (``WriteConfig.price_executor`` or
``PricingEngine(cost, executor=...)``) to ``"host"`` or ``"device"`` (on
CPU tensors the latter runs ``price_grid_ref``), and the JAX side is pinned
to the same executor or to its host executor.  Bounds:

* exact: staged positions, merge bursts, every per-batch merge decision and
  reason, capacities, tuned knobs and splits, and the structural count of
  one engine call per decision event;
* <= 2e-6: hit rates, among them every cell each decision event priced;
* rtol 1e-5: tuned ``est_io``, and the per-query I/O at C(d) and C(0), the
  merge-burst I/O and the read and merge ledgers where (1 - h) E[DAC] lies
  well above float32's resolution of h.  The session's buffer holds nearly
  every hot page, so h sits within a few float32 ulps of 1 and those I/O
  figures are held to rtol 1e-5 or the 2e-6 hit-rate bound carried
  through (1 - h) E[DAC], whichever is wider (ROADMAP Queue 3).
"""
import io
from contextlib import redirect_stdout

import numpy as np
import pytest

from repro.core.cam import CamGeometry as JGeom
from repro.core.session import CostSession as JCost
from repro.core.session import GridCandidate as JCand
from repro.core.session import System as JSystem
from repro.core.workload import Workload as JW
from repro.engine import PriceTable as JTable
from repro.engine import PricingEngine as JEngine
from repro.index import adapters as jad
from repro.serving import trace as jtr
from repro.tuning import session as jtun
from repro.write import delta as jdelta
from repro.write import scheduler as jsched
from repro.write import session as jws
from repro_torch.core.cam import CamGeometry
from repro_torch.core.session import CostSession, GridCandidate, System
from repro_torch.core.workload import Workload
from repro_torch.engine import PriceTable, PricingEngine
from repro_torch.index import adapters as tad
from repro_torch.launch import bench_write_path
from repro_torch.serving import trace as ttr
from repro_torch.tuning import session as ttun
from repro_torch.write import delta as tdelta
from repro_torch.write import scheduler as tsched
from repro_torch.write import session as tws

POLICIES = ("lru", "fifo", "lfu")
EXECUTORS = ("host", "device")
SCHEDULERS = ("cam", "every_k", "on_full")
IO_RTOL = 1e-5
H_ATOL = 2e-6


def _scheduler(mod, name):
    return {"cam": mod.CamMergeScheduler, "on_full": mod.OnFullScheduler,
            "every_k": lambda: mod.EveryKScheduler(k=6)}[name]()


# ---------------------------------------------------------------------------
# Delta staging, bursts and the read/write split
# ---------------------------------------------------------------------------

def _rw_batch(W, n, seed):
    rng = np.random.default_rng(seed)
    return W.mixed(W.point(rng.integers(0, n, 50), n=n),
                   W.insert(rng.integers(0, n, 40), n=n),
                   W.update(rng.integers(0, n, 30), n=n),
                   W.range_scan(np.arange(5), np.arange(5) + 9, n=n),
                   W.delete(rng.integers(0, n, 10), n=n))


def test_delta_buffer_and_merge_burst_match_jax():
    n, c_ipp = 20_000, 64
    jd = jdelta.DeltaBuffer(capacity_entries=150, entry_bytes=64.0)
    td = tdelta.DeltaBuffer(capacity_entries=150, entry_bytes=64.0)
    for seed in range(3):
        assert td.stage(_rw_batch(Workload, n, seed)) \
            == jd.stage(_rw_batch(JW, n, seed))
        assert (td.entries, td.full, td.stolen_pages(4096)) \
            == (jd.entries, jd.full, jd.stolen_pages(4096))
    np.testing.assert_array_equal(td.positions(), jd.positions())
    tb = tdelta.merge_burst_workload(td.positions(), n, c_ipp)
    jb = jdelta.merge_burst_workload(jd.positions(), n, c_ipp)
    assert tb.kind == jb.kind == "sorted" and tb.n == jb.n
    np.testing.assert_array_equal(tb.positions, jb.positions)
    np.testing.assert_array_equal(tb.hi_positions, jb.hi_positions)
    assert td.clear() == jd.clear() and td.merges == jd.merges == 1
    with pytest.raises(ValueError):
        tdelta.merge_burst_workload(td.positions(), n, c_ipp)


def test_split_reads_writes_matches_jax():
    n = 4096
    for seed in range(2):
        tr, tw = tws.split_reads_writes(_rw_batch(Workload, n, seed))
        jr, jw = jws.split_reads_writes(_rw_batch(JW, n, seed))
        for g, w in ((tr, jr), (tw, jw)):
            assert (g.kind, g.n_queries) == (w.kind, w.n_queries)
            assert [p.kind for p in g.parts] == [p.kind for p in w.parts]
    r, w = tws.split_reads_writes(Workload.point(np.asarray([7]), n=n))
    assert w is None and r.n_queries == 1


def test_scheduler_decisions_match_jax():
    """Every scheduler over a grid of priced contexts: the same verdict
    and reason as JAX's."""
    rng = np.random.default_rng(4)
    for _ in range(200):
        ctx = dict(batch_index=int(rng.integers(0, 40)),
                   io_defer=float(rng.uniform(0.5, 2.0)),
                   io_merged=float(rng.uniform(0.5, 2.0)),
                   merge_io=float(rng.uniform(0.0, 50.0)),
                   horizon_queries=float(rng.uniform(1.0, 100.0)),
                   delta_entries=int(rng.integers(0, 10)),
                   delta_full=bool(rng.random() < 0.2),
                   batches_since_merge=int(rng.integers(0, 12)))
        for name in SCHEDULERS:
            got = _scheduler(tsched, name).decide(
                tsched.DecisionContext(**ctx))
            want = _scheduler(jsched, name).decide(
                jsched.DecisionContext(**ctx))
            assert (got.merge, got.reason) == (want.merge, want.reason)
            assert got.benefit == pytest.approx(want.benefit, rel=1e-12)


# ---------------------------------------------------------------------------
# WriteSession: every scheduler, both executors
# ---------------------------------------------------------------------------

GEOM_KW = dict(c_ipp=64, page_bytes=4096)
KEYS = np.sort(np.random.default_rng(21).uniform(0, 1e9, 30_000))
SEGMENTS = [
    {"events": 1000, "mix": (0.85, 0.05, 0.0, 0.1, 0.0, 0.0),
     "hot_width": 0.08, "hot_frac": 0.95},
    {"events": 1400, "mix": (0.25, 0.0, 0.0, 0.55, 0.15, 0.05),
     "hot_center": 0.7, "hot_width": 0.25, "hot_frac": 0.8},
    {"events": 1200, "mix": (0.92, 0.03, 0.0, 0.05, 0.0, 0.0),
     "hot_width": 0.08, "hot_frac": 0.95},
]


def _write_run(pkg, scheduler, executor, policy):
    """One arm of tests/test_write_path.py's session world in ``pkg``."""
    geom, sys_, cand, ws, tr, kw = (
        (JGeom, JSystem, JCand, jws, jtr, {}) if pkg == "jax" else
        (CamGeometry, System, GridCandidate, tws, ttr,
         {"torch_device": "cpu"}))
    g = geom(**GEOM_KW)
    system = sys_(g, 80 * g.page_bytes, policy, **kw)
    config = ws.WriteConfig(batch_size=200, delta_capacity_entries=6000,
                            delta_entry_bytes=256.0, horizon_batches=12.0,
                            price_executor=executor)
    trace = tr.synthetic_drifting_trace(KEYS, SEGMENTS, seed=9)
    sess = ws.WriteSession(KEYS, system,
                           _scheduler(jsched if pkg == "jax" else tsched,
                                      scheduler),
                           candidate=cand(knob="live", eps=64,
                                          size_bytes=4096.0),
                           config=config)
    priced, real = [], sess.engine.price

    def price(table, **kw):
        sol = real(table, **kw)
        priced.append((sol.hit_rates, sol.io,
                       np.asarray(table.profiles.dacs)[table.rows]))
        return sol

    sess.engine.price = price
    report = sess.run(trace)
    return sess, report, priced


def _assert_reports_equal(got, want, got_priced, want_priced):
    assert len(got.records) == len(want.records) == 18
    events = [r for r in want.records if r.reason != "no_reads_yet"]
    assert len(got_priced) == len(want_priced) == len(events)
    tol = {"read_io": 0.0, "merge_io": 0.0}
    priced = iter(zip(got_priced, want_priced))
    for g, w in zip(got.records, want.records):
        assert (g.batch_index, g.n_reads, g.n_writes, g.delta_entries,
                g.cap_now, g.cap_empty, g.merged, g.reason) \
            == (w.batch_index, w.n_reads, w.n_writes, w.delta_entries,
                w.cap_now, w.cap_empty, w.merged, w.reason)
        if w.reason == "no_reads_yet":
            continue
        (h_g, _, _), (h_w, io_w, dac_w) = next(priced)
        assert h_g.shape == h_w.shape
        assert np.max(np.abs(h_g - h_w)) < H_ATOL
        # the hit-rate bound carried through each cell's (1 - h) E[DAC]
        abs_io = H_ATOL * dac_w
        burst = (w.merge_io / io_w[2] * abs_io[2]
                 if h_w.shape[0] == 3 and io_w[2] else 0.0)
        row = {"io_defer": abs_io[0], "io_merged": abs_io[1],
               "merge_io": burst, "read_io": abs_io[0] * w.n_reads}
        for f, a in row.items():
            assert getattr(g, f) == pytest.approx(getattr(w, f),
                                                  rel=IO_RTOL, abs=a), f
        tol["read_io"] += row["read_io"]
        tol["merge_io"] += burst if w.merged else 0.0
    assert (got.scheduler, got.merges, got.engine_calls,
            got.decision_events) == (want.scheduler, want.merges,
                                     want.engine_calls, want.decision_events)
    assert got.engine_calls == got.decision_events > 0
    tol["total_io"] = tol["read_io"] + tol["merge_io"]
    for f, a in tol.items():
        assert getattr(got, f) == pytest.approx(getattr(want, f),
                                                rel=IO_RTOL, abs=a), f


@pytest.mark.parametrize("executor", EXECUTORS)
@pytest.mark.parametrize("scheduler", SCHEDULERS)
def test_write_session_matches_jax(scheduler, executor):
    """The burst trace under each scheduler: one engine call per decision
    event, every per-batch decision and ledger row equal to JAX's."""
    tsess, got, got_priced = _write_run("torch", scheduler, executor, "lru")
    _, want, want_priced = _write_run("jax", scheduler, executor, "lru")
    _assert_reports_equal(got, want, got_priced, want_priced)
    assert set(tsess.engine._instances) == {executor}
    # the priced tables held write streams: the burst row is a sorted
    # stream, the read rows carry the live mix's writes after a merge
    assert any(r.merged for r in got.records) == (scheduler != "on_full")


@pytest.mark.parametrize("policy", ("fifo", "lfu"))
def test_write_session_other_policies_match_jax(policy):
    _, got, got_priced = _write_run("torch", "cam", "device", policy)
    _, want, want_priced = _write_run("jax", "cam", "host", policy)
    _assert_reports_equal(got, want, got_priced, want_priced)


# ---------------------------------------------------------------------------
# Write tables through both executors
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small_keys():
    return np.sort(np.random.default_rng(11).uniform(0, 1e9, 20_000))


def _rw_workload(W, keys, w_frac, seed=5):
    n = len(keys)
    rng = np.random.default_rng(seed)
    reads = W.point(rng.integers(0, n, 3000), n=n)
    writes = W.insert(rng.integers(0, n, int(3000 * w_frac)), n=n)
    return W.mixed(reads, writes)


@pytest.mark.parametrize("policy", POLICIES)
def test_write_tables_match_jax_on_both_executors(small_keys, policy):
    """Write-stream columns: the port's host and device executors give
    JAX's hit rates (<= 2e-6) and its winner up to objective ties."""
    budget = float(4 << 20)
    jsess = JCost(JSystem(JGeom(), budget, policy))
    tsess = CostSession(System(CamGeometry(), budget, policy,
                               torch_device="cpu"))
    pj = jsess.grid_profiles([JCand(e, 65_536.0, eps=e) for e in (8, 32, 64)],
                             _rw_workload(JW, small_keys, 0.7))
    pt = tsess.grid_profiles(
        [GridCandidate(e, 65_536.0, eps=e) for e in (8, 32, 64)],
        _rw_workload(Workload, small_keys, 0.7))
    assert pt.wparts and len(pt.wparts) == len(pj.wparts)
    for gw, ww in zip(pt.wparts, pj.wparts):
        assert gw.total_refs == pytest.approx(ww.total_refs, rel=1e-7)
    kw = dict(splits=(0.25, 0.5, 0.75), budget_bytes=budget,
              page_bytes=4096)
    want = JEngine(jsess).price(
        JTable.from_profiles(pj, {k: {} for k in pj.knobs}, **kw),
        executor="host")
    table = PriceTable.from_profiles(pt, {k: {} for k in pt.knobs}, **kw)
    for ex in EXECUTORS:
        got = PricingEngine(tsess, executor=ex).price(table)
        assert np.max(np.abs(got.hit_rates - want.hit_rates)) < H_ATOL, ex
        assert np.isclose(want.objective[got.best_cell],
                          want.objective[want.best_cell], rtol=IO_RTOL)


# ---------------------------------------------------------------------------
# The updatable adapters (gapped array, B+-tree) through the tuner
# ---------------------------------------------------------------------------

BUILDERS = {"alex": ("ALEXBuilder", "gap_density", "ALEXAdapter"),
            "btree": ("BTreeBuilder", "fill_factor", "BTreeAdapter")}


@pytest.mark.parametrize("executor", EXECUTORS)
@pytest.mark.parametrize("family", sorted(BUILDERS))
def test_updatable_builders_tune_one_solve(small_keys, family, executor):
    """ALEX (gapped array) and B+-tree tunes on a read/write mix: one
    engine call, JAX's knob, split and capacity, ``est_io`` at rtol 1e-5,
    every cell's hit rate within 2e-6."""
    builder, knob, adapter = BUILDERS[family]
    jts = jtun.TuningSession(JSystem(JGeom(), 4 << 20, "lru"))
    tts = ttun.TuningSession(System(CamGeometry(), 4 << 20, "lru",
                                    torch_device="cpu"))
    jts.cost._engine = JEngine(jts.cost, executor=executor)
    tts.cost._engine = PricingEngine(tts.cost, executor=executor)
    want = jts.tune(getattr(jtun, builder)(small_keys),
                    _rw_workload(JW, small_keys, 0.5))
    got = tts.tune(getattr(ttun, builder)(small_keys),
                   _rw_workload(Workload, small_keys, 0.5))
    assert got.batched_solves == 1 and tts.cost.engine.calls == 1
    assert (got.best, got.split, got.capacity_pages) \
        == (want.best, want.split, want.capacity_pages)
    assert got.best[knob] in getattr(tad, adapter).knob_metadata()[knob][
        "grid"]
    assert got.est_io == pytest.approx(want.est_io, rel=IO_RTOL)
    assert set(got.table) == set(want.table)
    for kn, cells in want.table.items():
        for g, w in zip(got.table[kn], cells):
            assert g.capacity_pages == w.capacity_pages
            assert abs(g.hit_rate - w.hit_rate) < H_ATOL


def test_alex_gap_density_tracks_write_intensity_as_jax(small_keys):
    """Write-heavier traffic tunes to more slack, in both packages."""
    picks = {}
    for pkg, (tun, sys_, geom, W, kw) in {
            "jax": (jtun, JSystem, JGeom, JW, {}),
            "torch": (ttun, System, CamGeometry, Workload,
                      {"torch_device": "cpu"})}.items():
        ts = tun.TuningSession(sys_(geom(), 4 << 20, "lru", **kw))
        picks[pkg] = [ts.tune(tun.ALEXBuilder(small_keys),
                              _rw_workload(W, small_keys, f)
                              ).best["gap_density"] for f in (0.05, 2.0)]
    assert picks["torch"] == picks["jax"]
    assert picks["torch"][1] >= picks["torch"][0]


def test_adapter_write_amplification_matches_jax(small_keys):
    """The adapters' write streams carry JAX's write amplification."""
    wl = {"jax": _rw_workload(JW, small_keys, 1.0),
          "torch": _rw_workload(Workload, small_keys, 1.0)}
    jsess = JCost(JSystem(JGeom(), 4 << 20, "lru"))
    tsess = CostSession(System(CamGeometry(), 4 << 20, "lru",
                               torch_device="cpu"))
    for build, kw in (("ALEXAdapter", {"gap_density": 0.1}),
                      ("BTreeAdapter", {"fill_factor": 0.67})):
        ja = getattr(jad, build).build(small_keys, **kw)
        ta = getattr(tad, build).build(small_keys, **kw)
        assert (ta.slots, ta.size_bytes) == (ja.slots, ja.size_bytes)
        pj = jsess.grid_profiles([JCand(knob="a", eps=ja.eps,
                                        size_bytes=ja.size_bytes, index=ja)],
                                 wl["jax"])
        pt = tsess.grid_profiles([GridCandidate(knob="a", eps=ta.eps,
                                                size_bytes=ta.size_bytes,
                                                index=ta)], wl["torch"])
        assert pt.wparts[0].total_refs == pytest.approx(
            pj.wparts[0].total_refs, rel=1e-7)
        assert pt.wparts[0].total_refs / 3000.0 >= 1.0
        np.testing.assert_allclose(pt.wparts[0].counts.double().numpy(),
                                   np.asarray(pj.wparts[0].counts,
                                              np.float64), rtol=0,
                                   atol=H_ATOL * float(
                                       np.asarray(pj.wparts[0].counts).max()))


# ---------------------------------------------------------------------------
# The benchmark twin
# ---------------------------------------------------------------------------

def test_bench_write_path_smoke_gates():
    """``--smoke`` on the CPU: CAM >= 1.2x merge-on-full, no worse than
    every-K, one engine call per decision event in every arm."""
    with redirect_stdout(io.StringIO()):
        rec = bench_write_path.run(smoke=True, torch_device="cpu")
    assert all(rec["gates"].values()) and len(rec["gates"]) == 3
    assert rec["on_full_over_cam_io"] >= 1.2
    assert rec["every_k_over_cam_io"] >= 1.0
    for arm in rec["arms"].values():
        assert arm["engine_calls"] == arm["decision_events"] > 0
