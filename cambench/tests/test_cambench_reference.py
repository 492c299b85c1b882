"""The plain reference against the port on tiny cases, the control failing
the check, and faults planted in the timed path failing it."""
import numpy as np
import pytest
import torch

from _util import rehearse_context


def test_point_counts_match_port():
    from repro_torch.core import page_ref
    from cambench.reference.cam import point_counts

    rng = np.random.default_rng(0)
    n, c = 50_000, 256
    pages = -(-n // c)
    pos = torch.as_tensor(rng.integers(0, n, 3000))
    for eps in (4, 64, 300, 1500):
        got, _ = page_ref.point_page_refs(pos, eps, c, pages)
        want = point_counts(pos, eps, c, pages)
        assert torch.allclose(got.double(), want, rtol=1e-5, atol=1e-5)


def test_point_counts_brute_force():
    from cambench.reference.cam import point_counts

    n, c, eps = 2000, 16, 21
    pos = torch.as_tensor([0, 5, 17, 999, 1999, 1500])
    want = np.zeros(-(-n // c))
    for r in pos.tolist():
        for e in range(-eps, eps + 1):
            lo, hi = r + e - eps, r + e + eps
            for p in range(len(want)):
                if lo <= (p + 1) * c - 1 and p * c <= hi:
                    want[p] += 1.0 / (2 * eps + 1)
    got = point_counts(pos, eps, c, len(want)).numpy()
    assert np.allclose(got, want, atol=1e-12)


@pytest.mark.parametrize("policy", ["lru", "fifo", "lfu"])
def test_hit_rates_match_port(policy):
    from repro_torch.core import cache_models
    from cambench.reference.cam import hit_rates

    rng = np.random.default_rng(1)
    counts = torch.as_tensor(rng.zipf(1.4, (3, 4000)).astype(np.float64))
    counts[:, rng.random(4000) < 0.2] = 0
    caps = np.asarray([1, 10, 300, 3999, 0, 5000])
    rows = np.asarray([0, 1, 2, 0, 1, 2])
    want = hit_rates(counts, rows, caps, [policy] * 6)
    c32 = counts.float()[torch.as_tensor(rows)]
    got, _ = cache_models.hit_rate_grid(policy, c32, c32.sum(1), c32.sum(1),
                                        torch.as_tensor(caps))
    assert np.allclose(got.double().numpy(), want, atol=2e-6)


def test_frozen_builds_match_port():
    from repro_torch.data.datasets import make_dataset
    from repro_torch.index import pgm, rmi
    from repro_torch.tuning import fit
    from cambench.frozen.books import books_keys
    from cambench.reference import pgm as rpgm
    from cambench.reference.rmi import build_rmis

    keys = make_dataset("books", 100_000, seed=4)
    assert np.array_equal(keys, books_keys(100_000,
                                           np.random.default_rng(4)))
    built = build_rmis(keys, (64, 4096))
    for b, r in built.items():
        p = rmi.build_rmi(keys, b)
        assert np.array_equal(p.leaf_eps, r.leaf_eps)
        assert np.array_equal(p.route(keys[::13]), r.route(keys[::13]))
    sizes = [pgm.build_pgm(keys, e).size_bytes for e in rpgm.SAMPLE_EPS]
    assert sizes == [rpgm.pgm_size_bytes(keys, e) for e in rpgm.SAMPLE_EPS]
    f = fit.fit_power_law(list(rpgm.SAMPLE_EPS), sizes)
    model = rpgm.pgm_size_model(keys)
    assert [float(f(e)) for e in (4, 91, 2896)] == \
        [model(e) for e in (4, 91, 2896)]


def test_frozen_positions_match_port():
    from repro_torch.data.workloads import WorkloadSpec as PSpec
    from repro_torch.data.workloads import point_positions as pp
    from cambench.frozen.workloads import WorkloadSpec, point_positions

    for name in ("w1", "w2", "w3", "w4", "w5", "w6"):
        assert np.array_equal(pp(300_000, 5000, PSpec(name, seed=9)),
                              point_positions(300_000, 5000,
                                              WorkloadSpec(name, seed=9)))


@pytest.mark.parametrize("cell", ["pgm.tune-w4", "rmi.tune-w4",
                                  "pgm.online-drift", "pgm.tune-policy-10k"])
def test_control_fails_the_check(cell):
    from cambench.control import CONTROLS

    ctx = rehearse_context(cell, seed=31)
    numbers = CONTROLS[ctx.traffic["driver"]](ctx)
    over = [k for k, v in numbers.items() if v > ctx.limits[k]]
    assert over, numbers


def _run_with(cell, monkeypatch, patch, seconds=1.0):
    import importlib

    ctx = rehearse_context(cell, seed=77, seconds=seconds)
    patch(monkeypatch)
    driver = importlib.import_module(
        f"cambench.drivers.{ctx.traffic['driver']}")
    # one thread: test workers beside each other oversubscribe the cores,
    # and a window that runs by the clock then holds only a few steps
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return driver.run(ctx)
    finally:
        torch.set_num_threads(threads)


def _half_batch(monkeypatch):
    from repro_torch.core.workload import Workload

    real = Workload.from_keys.__func__

    def half(cls, keys, query_keys):
        return real(cls, keys, query_keys[: len(query_keys) // 2])

    monkeypatch.setattr(Workload, "from_keys", classmethod(half))


def _half_events(monkeypatch):
    from repro_torch.serving import trace

    real = trace.compile_events

    def half(events, keys):
        return real(events[: len(events) // 2], keys)

    monkeypatch.setattr(trace, "compile_events", half)


def _altered_answer(monkeypatch):
    from repro_torch.core import cache_models

    real = cache_models.hit_rate_grid

    def shifted(*a, **kw):
        h, nd = real(*a, **kw)
        return h * 0.999, nd

    monkeypatch.setattr(cache_models, "hit_rate_grid", shifted)


def _stream_len(cell) -> int:
    tr = rehearse_context(cell, seed=77).traffic
    events = sum(s["events"] for s in tr["segments"][tr["warm_segments"]:])
    return -(-events // tr["batch_size"])


def _late(monkeypatch, flag):
    """Set ``flag["on"]`` from the window's batch ``2 x len(stream)`` on:
    a fault that starts only after the stream's second cycle."""
    from cambench.drivers import common

    start = 2 * _stream_len("pgm.online-drift")
    real = common.Window.run

    def run(self, step):
        def late_step(i):
            flag["on"] = i >= start
            return step(i)
        return real(self, late_step)

    monkeypatch.setattr(common.Window, "run", run)


def _late_tv_shift(monkeypatch):
    import dataclasses

    from repro_torch.serving import session

    flag = {"on": False}
    _late(monkeypatch, flag)
    real = session.ServingSession.ingest

    def shifted(self, *a, **kw):
        rep = real(self, *a, **kw)
        if flag["on"]:
            rep = dataclasses.replace(rep, tv=rep.tv + 1e-3)
        return rep

    monkeypatch.setattr(session.ServingSession, "ingest", shifted)


def _late_hit_scale(monkeypatch):
    from repro_torch.core import cache_models

    flag = {"on": False}
    _late(monkeypatch, flag)
    real = cache_models.hit_rate_grid

    def scaled(*a, **kw):
        h, nd = real(*a, **kw)
        return (h * 0.999 if flag["on"] else h), nd

    monkeypatch.setattr(cache_models, "hit_rate_grid", scaled)


@pytest.mark.parametrize("cell,fault", [
    ("pgm.tune-w4", _half_batch), ("pgm.tune-w4", _altered_answer),
    ("rmi.tune-w4", _half_batch), ("rmi.tune-w4", _altered_answer),
    ("pgm.tune-policy-10k", _altered_answer),
    ("pgm.online-drift", _half_events), ("pgm.online-drift", _altered_answer),
    ("pgm.online-drift", _late_tv_shift),
    ("pgm.online-drift", _late_hit_scale)])
def test_planted_fault_is_not_correct(cell, fault, monkeypatch):
    late = fault in (_late_tv_shift, _late_hit_scale)
    out = _run_with(cell, monkeypatch, fault, seconds=4.0 if late else 1.0)
    assert out["attempted"] > (3 * _stream_len(cell) if late else 0)
    assert out["correct"] is False, out["checks"]


class _Counting:
    """Counts the reference's own computations of chunks and windows."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.calls = {"chunk": 0, "merged": 0, "price": 0}

    def chunk(self, batch):
        self.calls["chunk"] += 1
        return super().chunk(batch)

    def merged(self):
        self.calls["merged"] += 1
        return super().merged()

    def price(self, m):
        self.calls["price"] += 1
        return super().price(m)


@pytest.fixture(scope="module")
def online_replay():
    """A lower-precision run of the reference over three cycles and more
    of the stream (as the control makes one), and what replaying it needs."""
    import numpy as np

    from cambench.drivers.online import Inputs
    from cambench.reference.online import OnlineReference, run_alone
    from cambench.reference.tune import knob_sizes

    inp = Inputs(rehearse_context("pgm.online-drift", seed=2**31 + 203))
    sizes, _ = knob_sizes(inp)
    low = OnlineReference(inp, sizes, "cpu", profile_dtype=torch.float32,
                          price_dtype=torch.bfloat16,
                          summary_dtype=np.float32)
    n = 3 * len(inp.stream) + 11
    program = run_alone(low, inp.warm, inp.stream, n, inp.check_evaluations)
    return inp, sizes, program


def _follow(cls, replay):
    from cambench.reference.online import follow

    inp, sizes, program = replay
    ref = cls(inp, sizes, "cpu")
    return ref, follow(ref, inp.warm, inp.stream, program)


@pytest.mark.parametrize("bound", ["chunks", "windows", "cycles"])
def test_follow_computes_each_input_once(online_replay, bound):
    from cambench.reference.online import OnlineReference

    class Counting(_Counting, OnlineReference):
        pass

    inp, _, program = online_replay
    ref, _ = _follow(Counting, online_replay)
    batches = program["batches"]
    late = [b for b in batches[2 * len(inp.stream):] if b["decision"]]
    window = inp.serving["window_chunks"]
    if bound == "chunks":
        assert ref.calls["chunk"] <= len(inp.warm) + len(inp.stream)
    elif bound == "windows":
        assert ref.calls["price"] <= len(inp.stream) + window
        assert ref.calls["merged"] <= len(inp.stream) + window
    else:       # the program spans three cycles, evaluated in the third
        assert len(batches) >= 3 * len(inp.stream) and late


class _Recomputing(_Counting):
    def memo(self, store, key, make):
        return make()


@pytest.mark.parametrize("what", ["numbers", "windows"])
def test_follow_cached_equals_recomputed(online_replay, what):
    from cambench.reference.online import OnlineReference

    class Recomputing(_Recomputing, OnlineReference):
        pass

    inp, sizes, program = online_replay
    if what == "numbers":
        ref, every = _follow(Recomputing, online_replay)
        _, once = _follow(OnlineReference, online_replay)
        assert ref.calls["chunk"] == len(inp.warm) + len(program["batches"])
        assert once == every
        assert once["hit_err"] > 0 and once["profile_err"] > 0, once
        return
    # every window of the run, the cycles' wrap-arounds with them
    refs = (OnlineReference(inp, sizes, "cpu"), Recomputing(inp, sizes, "cpu"))
    for ref in refs:
        for i, batch in enumerate(inp.warm):
            ref.push(("warm", i), batch)
    for b in [None] + program["batches"]:
        if b is not None:
            for ref in refs:
                ref.push(("stream", b["stream_index"]),
                         inp.stream[b["stream_index"]])
        once, every = (ref.window_merged() for ref in refs)
        assert torch.equal(once["counts"], every["counts"])
        assert once["n"] == every["n"]
        assert (once["sorted"] or {}).get("pinned") == \
            (every["sorted"] or {}).get("pinned")
        assert refs[0].window_cells() == refs[1].window_cells()


def test_sound_run_is_correct(monkeypatch):
    out = _run_with("pgm.tune-w4", monkeypatch, lambda mp: None)
    assert out["correct"] is True, out["checks"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["pgm.tune-w4", "rmi.tune-w4",
                                  "pgm.online-drift", "pgm.tune-policy-10k"])
def test_control_fails_the_check_on_card(cell, cuda):
    from cambench.control import CONTROLS

    ctx = rehearse_context(cell, seed=31)
    ctx.device = "cuda"
    numbers = CONTROLS[ctx.traffic["driver"]](ctx)
    assert [k for k, v in numbers.items() if v > ctx.limits[k]], numbers
