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


def _run_with(cell, monkeypatch, patch):
    import importlib

    ctx = rehearse_context(cell, seed=77, seconds=1.0)
    patch(monkeypatch)
    driver = importlib.import_module(
        f"cambench.drivers.{ctx.traffic['driver']}")
    return driver.run(ctx)


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


@pytest.mark.parametrize("cell,fault", [
    ("pgm.tune-w4", _half_batch), ("pgm.tune-w4", _altered_answer),
    ("rmi.tune-w4", _half_batch), ("rmi.tune-w4", _altered_answer),
    ("pgm.tune-policy-10k", _altered_answer),
    ("pgm.online-drift", _half_events), ("pgm.online-drift", _altered_answer)])
def test_planted_fault_is_not_correct(cell, fault, monkeypatch):
    out = _run_with(cell, monkeypatch, fault)
    assert out["attempted"] > 0
    assert out["correct"] is False, out["checks"]


def test_sound_run_is_correct():
    from cambench.drivers import tune

    out = tune.run(rehearse_context("pgm.tune-w4", seed=77, seconds=1.0))
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
