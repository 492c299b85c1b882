"""The port's spans and transfer counters (``repro_torch.obs``).

On the CPU: the recorder records nothing while off; a ``torch.profiler``
turns it on and sees its spans as host events that are no user
annotations (so nothing mirrors them onto the device timeline); a tune
and a serving run give the span tree the CAM path promises; ``locate``
counts the queries it maps into the key dtype, and elsewhere the key-file
bytes ``searchsorted`` converts; and every output is
the same with the recorder on and off.  One ``cuda``-marked case counts
real transfers on the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_obs.py

This file imports no JAX.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.core.cam import CamGeometry
from repro_torch.core.session import System
from repro_torch.core.workload import Workload, locate
from repro_torch.engine import PricingEngine
from repro_torch.serving import ServingConfig, ServingSession
from repro_torch.serving import trace as tr
from repro_torch.tuning.session import (AnalyticSizeModel, PGMBuilder,
                                        RMIBuilder, TuningSession)

#: The benchmark harness's own span labels: no program span may take one.
HARNESS_LABELS = {"locate", "tune", "profile", "price", "compile", "sketch",
                  "retune", "harness"}
N_KEYS = 100_000
KEYS = np.sort(np.random.default_rng(0).integers(
    0, 2**62, N_KEYS, dtype=np.uint64))
GRID = {"eps": (8, 32, 128, 512)}
RMI_GRID = {"branch": (16, 64, 256)}
SEGMENTS = [
    {"events": 1024, "mix": (0.8, 0.2, 0.0), "hot_center": 0.2,
     "range_width": 16},
    {"events": 1024, "mix": (0.2, 0.4, 0.4), "hot_center": 0.7,
     "range_width": 256, "sorted_run": 16},
]

#: Each span of a tune request and of a served batch, and its parent.
TUNE_TREE = {
    "cam.tune": None,
    "cam.profile": "cam.tune",
    "cam.profile.upload": "cam.profile",
    "cam.profile.histogram": "cam.profile",
    "cam.table": "cam.tune",
    "cam.price": "cam.tune",
}
DEVICE_PRICE_TREE = {"cam.price.marshal": "cam.price",
                     "cam.price.launch": "cam.price"}
SERVING_TREE = {
    "serving.compile": None,
    "serving.ingest": None,
    "serving.sketch": "serving.ingest",
    "serving.sketch.chunk": "serving.sketch",
    "serving.drift": "serving.ingest",
    "serving.retune": "serving.ingest",
    "serving.merge": "serving.retune",
    "cam.profile": "serving.sketch",
    "cam.table": "serving.retune",
    "cam.price": "serving.retune",
}


@pytest.fixture(autouse=True)
def fresh_recorder():
    obs.disable()
    obs.reset()
    yield
    obs.disable()
    obs.reset()


def _size(eps):
    return 16.0 * N_KEYS / (2.0 * eps) + 64.0


def _session(executor="device", device="cpu"):
    system = System(CamGeometry(c_ipp=256, page_bytes=4096),
                    memory_budget_bytes=48 * 4096, policy="lru",
                    torch_device=device)
    ts = TuningSession(system, splits=(0.25, 0.5, 0.75))
    ts.cost._engine = PricingEngine(ts.cost, executor=executor)
    return ts


def _tune(ts, seed=1, queries=5000):
    qk = KEYS[np.random.default_rng(seed).integers(0, N_KEYS, queries)]
    wl = Workload.from_keys(KEYS, qk)
    return ts.tune(PGMBuilder(KEYS), wl, overrides=GRID,
                   size_model=AnalyticSizeModel(_size),
                   policies=("lru", "fifo", "lfu"))


def _serve(family="pgm"):
    ts = _session()
    if family == "pgm":
        builder, overrides = PGMBuilder(KEYS), GRID
        size_model = AnalyticSizeModel(_size)
    else:
        builder, overrides, size_model = RMIBuilder(KEYS), RMI_GRID, None
    srv = ServingSession(ts, builder, KEYS, overrides=overrides,
                         size_model=size_model,
                         config=ServingConfig(batch_size=256,
                                              window_chunks=2,
                                              drift_threshold=0.1,
                                              cooldown_batches=0))
    events = tr.synthetic_drifting_trace(KEYS, SEGMENTS, seed=3)
    initial = srv.start(events[:512])
    return initial, srv.observe(events[512:])


def _tune_answer(res):
    return (res.best, res.best_knob, res.split, res.capacity_pages,
            res.est_io, res.objective_value, res.table, res.skipped,
            res.batched_solves,
            {k: dataclasses.replace(e, estimation_seconds=0.0)
             for k, e in res.estimates.items()})


def _report_answer(rep):
    d = rep.decision
    return (rep.ts, rep.n_queries, rep.tv, rep.drifted,
            None if d is None else (d.io_current, d.io_candidate,
                                    d.rebuild_io, d.switched, d.from_knob,
                                    d.to_knob, _tune_answer(d.result)))


def _tree(records):
    by_id = {r.id: r for r in records}
    return by_id, {r.id: (None if r.parent is None else by_id[r.parent].name)
                   for r in records}


# ---------------------------------------------------------------------------
# Off, and under a profiler
# ---------------------------------------------------------------------------

def test_off_records_nothing():
    assert not obs.active()
    _tune(_session())
    _serve()
    snap = obs.snapshot()
    assert obs.records() == []
    assert snap["spans"] == {} and snap["counters"] == {}
    assert snap["records"] == 0 and snap["dropped"] == 0


def test_profiler_turns_the_recorder_on_and_sees_every_span():
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        assert obs.active()
        _tune(_session())
        _serve()
    assert not obs.active()
    spans = set(obs.snapshot()["spans"])
    want = (set(TUNE_TREE) | set(DEVICE_PRICE_TREE) | set(SERVING_TREE)
            | {"cam.locate"})
    assert want <= spans
    assert not spans & HARNESS_LABELS
    events = [e for e in prof.events() if e.name in spans]
    assert {e.name for e in events} == spans
    # function-scope events: nothing mirrors them onto the device timeline
    assert not any(getattr(e, "is_user_annotation", False) for e in events)


# ---------------------------------------------------------------------------
# The span tree
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("executor", ("host", "device"))
def test_tune_span_tree(executor):
    ts = _session(executor)
    obs.enable()
    _tune(ts, seed=1)
    _tune(ts, seed=2)
    obs.disable()
    records = obs.records()
    by_id, parent_of = _tree(records)
    want = dict(TUNE_TREE, **({} if executor == "host"
                              else DEVICE_PRICE_TREE), **{"cam.locate": None})
    assert {r.name for r in records} == set(want)
    for r in records:
        assert parent_of[r.id] == want[r.name], r
        assert r.start_ns <= r.end_ns
        if r.parent is not None:
            p = by_id[r.parent]
            assert p.start_ns <= r.start_ns and r.end_ns <= p.end_ns
            assert r.request == p.request
    roots = [r for r in records if r.parent is None]
    assert [r.name for r in sorted(roots, key=lambda r: r.start_ns)] == [
        "cam.locate", "cam.tune"] * 2
    assert len({r.request for r in roots}) == 4
    snap = obs.snapshot()
    for name, s in snap["spans"].items():
        assert s["calls"] == 2 * (name in want)
        assert 0.0 <= s["self_ms"] <= s["total_ms"]
    children = sum(snap["spans"][n]["total_ms"]
                   for n, p in want.items() if p == "cam.tune")
    tune = snap["spans"]["cam.tune"]
    assert tune["self_ms"] == pytest.approx(tune["total_ms"] - children,
                                            abs=1e-6)
    # CPU tensors cross no bus, and uint64 query keys convert nothing
    assert snap["counters"] == {} and snap["counters_by_span"] == {}


def test_serving_span_tree():
    obs.enable()
    _, reports = _serve()
    obs.disable()
    records = obs.records()
    by_id, parent_of = _tree(records)
    assert set(SERVING_TREE) | {"cam.locate"} <= {r.name for r in records}
    # the start's sketch updates and first retune run outside any batch
    at_start = {"serving.sketch", "serving.retune"}
    for r in records:
        if r.name in SERVING_TREE:
            want = SERVING_TREE[r.name]
            assert parent_of[r.id] in ({want, None} if r.name in at_start
                                       else {want}), r
        elif r.name == "cam.locate":
            assert parent_of[r.id] == "serving.compile"
        if r.parent is not None:
            assert r.request == by_id[r.parent].request
    roots = [r for r in records if r.parent is None]
    assert len({r.request for r in roots}) == len(roots)
    ingests = [r for r in records if r.name == "serving.ingest"]
    assert len(ingests) == len(reports)
    under = {name: sum(r.name == name and parent_of[r.id] == "serving.ingest"
                       for r in records) for name in at_start}
    assert under["serving.sketch"] == len(reports)
    assert under["serving.retune"] == sum(r.decision is not None
                                          for r in reports) > 0


@pytest.mark.parametrize("family", ("rmi", "pgm"))
def test_routing_spans_under_each_batch(family):
    """An RMI grid routes and profiles each batch's ranges inside the
    batch's ``cam.profile``: one ``cam.route`` and one ``cam.profile.range``
    a batch, and ``route.keys`` counts every point key and both keys of
    every range once a candidate.  A PGM grid routes nothing."""
    obs.enable()
    _, reports = _serve(family)
    obs.disable()
    records = obs.records()
    snap = obs.snapshot()
    routing = {"cam.route", "cam.profile.range"}
    if family == "pgm":
        assert not routing & {r.name for r in records}
        assert "route.keys" not in snap["counters"]
        return
    by_id, parent_of = _tree(records)
    batches = {r.request for r in records if r.name == "serving.ingest"}
    assert len(batches) == len(reports)
    for name in routing:
        under = [r for r in records if r.name == name
                 and r.request in batches]
        assert sorted(r.request for r in under) == sorted(batches), name
        assert {parent_of[r.id] for r in under} == {"cam.profile"}
        assert {by_id[r.parent].request for r in under} == batches
    events = tr.synthetic_drifting_trace(KEYS, SEGMENTS, seed=3)
    keys = sum(2 if e.op == "range" else e.op == "point" for e in events)
    assert snap["counters"]["route.keys"] == len(RMI_GRID["branch"]) * keys
    assert snap["counters_by_span"]["cam.route"]["route.keys"] == \
        snap["counters"]["route.keys"]


# ---------------------------------------------------------------------------
# Counters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("query_dtype,shift", (
    (np.float64, 10), (np.uint64, 10), (np.float64, 0)),
    ids=("float64", "uint64", "float64-above-2**53"))
def test_locate_cast_bytes(query_dtype, shift):
    """Float queries into keys below 2**53 are mapped into the key dtype;
    above it, ``searchsorted`` converts the key file, and that counts."""
    keys = KEYS >> np.uint64(shift)
    qk = keys[::97].astype(query_dtype)
    obs.enable()
    pos = locate(keys, qk)
    obs.disable()
    counters = obs.snapshot()["counters"]
    if query_dtype is np.uint64:
        assert counters == {}
    elif keys[-1] <= 2**53:
        assert counters == {"locate.mapped_queries": qk.size}
    else:
        assert counters == {"locate.cast_bytes": keys.size * 8}
    np.testing.assert_array_equal(pos, locate(keys, qk))
    np.testing.assert_array_equal(
        pos, np.minimum(np.searchsorted(keys, qk), keys.size - 1))
    assert obs.snapshot()["counters"] == counters     # off: nothing added


def test_counters_charge_the_innermost_span():
    obs.enable()
    with obs.span("a"):
        obs.count("n", 2)
        with obs.span("b"):
            obs.count("n", 3)
    obs.count("n", 5)
    snap = obs.snapshot()
    assert snap["counters"] == {"n": 10}
    assert snap["counters_by_span"] == {"a": {"n": 2}, "b": {"n": 3}}


def test_traced_decorator_and_bounded_buffer():
    @obs.traced("f")
    def f(x):
        return x + 1

    rec = obs._RECORDER
    rec.max_records = 3
    try:
        assert f(1) == 2                      # off: a plain call
        assert obs.snapshot()["spans"] == {}
        obs.enable()
        assert [f(i) for i in range(5)] == [1, 2, 3, 4, 5]
        snap = obs.snapshot()
        assert snap["spans"]["f"]["calls"] == 5
        assert (snap["records"], snap["dropped"]) == (3, 2)
        assert len(obs.records()) == 3
        assert len({r.request for r in obs.records()}) == 3
    finally:
        rec.max_records = obs.MAX_RECORDS


def test_host_tensors_move_nothing():
    obs.enable()
    np.testing.assert_array_equal(obs.to_host(torch.arange(10)),
                                  np.arange(10))
    np.testing.assert_array_equal(obs.to_host([1.5, 2.5]), [1.5, 2.5])
    u = obs.to_device(np.arange(4, dtype=np.int32), "cpu", torch.float32)
    assert u.dtype == torch.float32 and u.device.type == "cpu"
    snap = obs.snapshot()
    assert snap["counters"] == {} and snap["spans"] == {}


# ---------------------------------------------------------------------------
# Outputs do not depend on the recorder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("executor", ("host", "device"))
def test_tune_result_same_on_and_off(executor):
    off = _tune_answer(_tune(_session(executor)))
    obs.enable()
    on = _tune_answer(_tune(_session(executor)))
    obs.disable()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        traced = _tune_answer(_tune(_session(executor)))
    assert on == off and traced == off


def test_serving_run_same_on_and_off():
    init_off, reps_off = _serve()
    obs.enable()
    init_on, reps_on = _serve()
    obs.disable()
    assert _tune_answer(init_on) == _tune_answer(init_off)
    assert [_report_answer(r) for r in reps_on] == [
        _report_answer(r) for r in reps_off]


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_transfers_counted_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the price_grid kernel has no CPU "
                    "mode)")
    obs.enable()
    t = obs.to_device(np.arange(1000, dtype=np.int64), "cuda")
    assert obs.to_device(t, "cuda") is t           # already there
    assert obs.to_device(t, "cuda", torch.float32).device == t.device
    inf = obs.to_device(float("inf"), torch.device("cuda"))
    assert inf.dtype == torch.float32 and inf.device.type == "cuda"
    np.testing.assert_array_equal(obs.to_host(t * 2), 2 * np.arange(1000))
    snap = obs.snapshot()
    # both uploads from host memory and the read block on the card
    assert snap["counters"] == {"h2d.bytes": 8004, "sync.count": 3,
                                "d2h.bytes": 8000}
    assert snap["spans"]["cam.h2d"]["calls"] == 2
    assert snap["spans"]["cam.d2h"]["calls"] == 1
    obs.reset()

    ts = _session("device", "cuda")
    off = _tune_answer(_tune(ts, seed=4))
    obs.reset()
    on = _tune_answer(_tune(ts, seed=4))
    assert on == off
    snap = obs.snapshot()
    by_span = snap["counters_by_span"]
    # profiling uploads the eps grid and the positions and reads the totals
    # back; pricing uploads the rows, sample sizes and +inf to marshal,
    # reads the per-row distinct counts and minima, uploads the table's
    # five arrays for the launch, and reads the hit rates and the argmin
    assert snap["counters"]["sync.count"] == 15
    assert {name: c["sync.count"] for name, c in by_span.items()
            if "sync.count" in c} == {
        "cam.profile": 2, "cam.profile.upload": 1, "cam.price.marshal": 3,
        "cam.price": 4, "cam.price.launch": 5}
    assert snap["spans"]["cam.d2h"]["calls"] == 5
    assert snap["spans"]["cam.h2d"]["calls"] == 10
    assert by_span["cam.profile.upload"]["h2d.bytes"] == 5000 * 8
    assert by_span["cam.profile"]["h2d.bytes"] == len(GRID["eps"]) * 8
