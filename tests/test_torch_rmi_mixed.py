"""An RMI grid's profiles of range, mixed and sorted-bearing batches.

The port's routing candidates (``RMIAdapter``) are held to the plain
float64 reference ``tests/_torch_rmi_ref.py`` on seeded books keys: every
branch's page counts, references, E[DAC] and sorted statistics, through the
grid's host and device executors and the single-candidate profile.  A range
widens each end by its own leaf's bound; a port that took the lower end's
bound at both ends fails the comparison.  A ``ServingSession`` over
``RMIBuilder`` ingests a drifting stream and its window profiles equal the
reference's.  PGM candidates are untouched: their grid profiles of mixed
batches are bit-equal with or without the range endpoints' keys, and to the
per-part composition of a mixed profile.

This file imports no JAX.
"""
import dataclasses

import numpy as np
import pytest
import torch

import _torch_rmi_ref as ref
from repro_torch import obs
from repro_torch.core.cam import CamGeometry
from repro_torch.core.session import (CostSession, GridCandidate, System,
                                      _merge_sorted_parts,
                                      uniform_eps_profile)
from repro_torch.data.datasets import make_dataset
from repro_torch.index.adapters import RMIAdapter
from repro_torch.serving import ServingConfig, ServingSession
from repro_torch.serving import trace as tr
from repro_torch.tuning.session import RMIBuilder, TuningSession

N = 200_000
C = 256
BRANCHES = (16, 256, 4096)
KEYS = make_dataset("books", N, seed=4)
GEOM = CamGeometry(c_ipp=C, page_bytes=4096)
P = GEOM.num_pages(N)

#: One 2,048-event batch of each shape, over a wide hot region.
BATCHES = {
    "range": {"mix": (0.0, 1.0, 0.0), "range_width": 2048},
    "mixed": {"mix": (0.5, 0.5, 0.0), "range_width": 256},
    "sorted": {"mix": (0.2, 0.4, 0.4), "range_width": 1024,
               "sorted_run": 64},
}
#: A drifting stream: hot set moves, then wide ranges, then sorted runs.
STREAM = [
    {"events": 768, "mix": (0.8, 0.2, 0.0), "hot_center": 0.2,
     "hot_width": 0.05, "range_width": 16},
    {"events": 512, "mix": (0.8, 0.2, 0.0), "hot_center": 0.6,
     "hot_width": 0.05, "range_width": 16},
    {"events": 768, "mix": (0.1, 0.8, 0.1), "hot_center": 0.75,
     "hot_width": 0.4, "range_width": 2048},
    {"events": 1024, "mix": (0.2, 0.4, 0.4), "hot_center": 0.5,
     "hot_width": 0.6, "range_width": 1024, "sorted_run": 64},
]


@pytest.fixture(scope="module")
def candidates():
    return [GridCandidate(knob=b, size_bytes=float(16 + 24 * b),
                          index=RMIAdapter.build(KEYS, b)) for b in BRANCHES]


def _batch(shape: str, seed: int = 5):
    seg = {"events": 2048, "hot_center": 0.5, "hot_width": 0.6,
           **BATCHES[shape]}
    return tr.compile_events(tr.synthetic_drifting_trace(KEYS, [seg],
                                                         seed=seed), KEYS)


def _cost():
    return CostSession(System(GEOM, 2 << 20, "lru", torch_device="cpu"))


def _ref_batch(wl) -> dict:
    """The reference's view of a compiled batch: keys and ranks by op."""
    out = {}
    for p in (wl.parts if wl.kind == "mixed" else (wl,)):
        if p.kind == "point":
            out["point"] = (p.query_keys, p.positions)
        elif p.kind == "range":
            out["range"] = (p.query_keys, p.hi_query_keys, p.positions,
                            p.hi_positions)
        else:
            out["sorted"] = (p.positions, p.hi_positions)
    return out


def _rel(got, want) -> float:
    got = torch.as_tensor(np.asarray(got, np.float64)).double()
    return float((got - want).abs().max() / want.abs().max())


def _assert_row(counts, total, dac, sp, want):
    """One candidate's row against the reference: float32 histograms of
    float64 sums, integer range and sorted statistics exact."""
    assert _rel(counts, want["counts"]) < 2e-6
    assert total == pytest.approx(want["total"], rel=1e-6)
    assert dac == pytest.approx(want["dac"], rel=1e-6)
    ws = want["sorted"]
    assert (sp is None) == (ws is None)
    if ws is not None:
        assert (sp.total_refs, sp.distinct_pages, sp.pinned_retouches,
                sp.min_capacity) == (ws["refs"], ws["distinct"],
                                     ws["pinned"], ws["min_cap"])
        assert _rel(sp.coverage, torch.as_tensor(ws["coverage"])) == 0.0


def _want(candidates, wl, **kw):
    return [ref.profile(c.index.index, _ref_batch(wl), C, P, **kw)
            for c in candidates]


def _assert_grid(candidates, wl, executor, **kw):
    prof = _cost().grid_profiles(candidates, wl, executor=executor)
    assert prof.knobs == BRANCHES and not prof.skipped
    for i, want in enumerate(_want(candidates, wl, **kw)):
        _assert_row(prof.counts[i], prof.totals[i], prof.dacs[i],
                    prof.sparts[i], want)


def test_range_ends_take_bounds_that_differ(candidates):
    """The batches below route a range's two ends to leaves whose bounds
    differ, for every branch: the per-endpoint rule is exercised."""
    wl = _batch("range")
    for c in candidates:
        e_lo, e_hi = c.index.range_ref_eps(wl, GEOM)
        assert np.count_nonzero(e_lo != e_hi) > 0, c.knob


@pytest.mark.parametrize("executor", ("host", "device"))
@pytest.mark.parametrize("shape", sorted(BATCHES))
def test_grid_rows_match_reference(candidates, shape, executor):
    _assert_grid(candidates, _batch(shape), executor)


@pytest.mark.parametrize("shape", sorted(BATCHES))
def test_single_candidate_profile_matches_reference(candidates, shape):
    wl = _batch(shape, seed=6)
    for c, want in zip(candidates, _want(candidates, wl)):
        prof = c.index.page_ref_profile(wl, GEOM, device="cpu")
        counts = (prof.counts if prof.counts is not None
                  else torch.zeros(P))
        total = prof.total_refs if not prof.sorted_stream else 0.0
        _assert_row(counts, total, prof.expected_dac, prof.sorted_part, want)


@pytest.mark.parametrize("executor", ("host", "device"))
def test_lower_bound_at_both_ends_fails(candidates, executor, monkeypatch):
    """A port that widened both ends of a range by the lower end's bound
    would pass a reference that did the same, and fails the real one."""
    real = RMIAdapter.range_ref_eps

    def lower_twice(self, workload, geom):
        e_lo, _ = real(self, workload, geom)
        return e_lo, e_lo

    monkeypatch.setattr(RMIAdapter, "range_ref_eps", lower_twice)
    wl = _batch("mixed", seed=7)
    _assert_grid(candidates, wl, executor, same_bound=True)
    with pytest.raises(AssertionError):
        _assert_grid(candidates, wl, executor)


def test_serving_session_windows_match_reference():
    """A ServingSession over RMIBuilder ingests every batch of a drifting
    stream, and after each its window's profiles are the reference's sum
    of the window's batches."""
    system = System(GEOM, 1 << 20, "lru", torch_device="cpu")
    cfg = ServingConfig(batch_size=256, window_chunks=4,
                        drift_threshold=0.12, hysteresis=0.04,
                        cooldown_batches=1, horizon_queries=30_000)
    srv = ServingSession(TuningSession(system, splits=(0.25, 0.5, 0.75)),
                         RMIBuilder(KEYS), KEYS,
                         overrides={"branch": BRANCHES}, config=cfg)
    events = tr.synthetic_drifting_trace(KEYS, STREAM, seed=9)
    srv.start(events[:512])
    rmis = [c.index.index for c in srv.candidates]

    def profiles(batch):
        wl = tr.compile_events(batch, KEYS)
        return [ref.profile(r, _ref_batch(wl), C, P) for r in rmis]

    done = [profiles(b) for b in tr.iter_batches(events[:512],
                                                 cfg.batch_size)]
    for batch in tr.iter_batches(events[512:], cfg.batch_size):
        wl = tr.compile_events(batch, KEYS)
        srv.ingest(wl, ts=batch[-1].ts)
        done.append(profiles(batch))
        prof = srv.sketch.to_profiles()
        for i, r in enumerate(rmis):
            want = ref.window([d[i] for d in done[-cfg.window_chunks:]])
            _assert_row(prof.counts[i], prof.totals[i], prof.dacs[i],
                        prof.sparts[i], want)
    assert srv.stats.batches == len(done) - 2 == -(-(len(events) - 512)
                                                   // 256)
    assert srv.stats.retune_evaluations >= 1


def _pgm_candidates():
    return [GridCandidate(knob=e, eps=e, size_bytes=1e4 / e)
            for e in (8, 64, 512)]


def _strip_keys(wl):
    return dataclasses.replace(wl, parts=tuple(
        dataclasses.replace(p, query_keys=None, hi_query_keys=None)
        if p.kind == "range" else p for p in wl.parts))


@pytest.mark.parametrize("shape", ("mixed", "sorted"))
def test_pgm_mixed_profiles_bit_equal(shape):
    """PGM grid profiles of a mixed batch do not see the range endpoints'
    keys, and a mixed profile composes its parts as before."""
    wl = _batch(shape, seed=8)
    cost = _cost()
    got = cost.grid_profiles(_pgm_candidates(), wl)
    want = cost.grid_profiles(_pgm_candidates(), _strip_keys(wl))
    assert torch.equal(got.counts, want.counts)
    assert np.array_equal(got.totals, want.totals)
    assert np.array_equal(got.dacs, want.dacs)
    for a, b in zip(got.sparts, want.sparts):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a.coverage, b.coverage)
            assert dataclasses.replace(a, coverage=None) == \
                dataclasses.replace(b, coverage=None)
    for eps in (8, 64, 512):
        prof = uniform_eps_profile(wl, eps, GEOM, N, device="cpu")
        parts = [uniform_eps_profile(p, eps, GEOM, N, device="cpu")
                 for p in wl.parts]
        counts = torch.zeros(P)
        total, dac_mass = 0.0, 0.0
        for p, pp in zip(wl.parts, parts):
            dac_mass += pp.expected_dac * p.n_queries
            if not pp.sorted_stream:
                counts = counts + pp.counts
                total += pp.total_refs
        assert torch.equal(prof.counts, counts) and prof.total_refs == total
        assert prof.expected_dac == dac_mass / wl.n_queries
        srt = [pp.sorted_part for pp in parts if pp.sorted_part is not None]
        if srt:
            sp = _merge_sorted_parts(srt)
            assert torch.equal(prof.sorted_part.coverage, sp.coverage)
            assert prof.sorted_part.total_refs == sp.total_refs


def test_routing_counts_every_key(candidates):
    """``route.keys`` counts each point key and both keys of each range,
    once a candidate (the memo routes a workload once)."""
    wl = _batch("sorted", seed=10)
    n_keys = sum(p.n_queries * (2 if p.kind == "range" else 1)
                 for p in wl.parts if p.kind != "sorted")
    obs.reset()
    obs.enable()
    try:
        cost = _cost()
        cost.grid_profiles(candidates, wl)
        cost.grid_profiles(candidates, wl)
        counters = obs.snapshot()["counters"]
    finally:
        obs.disable()
        obs.reset()
    assert counters["route.keys"] == len(BRANCHES) * n_keys
