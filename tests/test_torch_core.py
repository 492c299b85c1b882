"""Port estimator math vs the JAX reference on shared numpy inputs (CPU).

``core/dac``, ``core/page_ref`` and ``core/cache_models`` of
``repro_torch`` against ``repro``: histograms exact where the mass is
integer, <= 2e-6 normalized otherwise; hit rates <= 2e-6 (float32
summation order); regime compares exact, including capacities above 2^24.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cache_models as jcm
from repro.core import dac as jdac
from repro.core import page_ref as jpr
from repro_torch.core import cache_models as tcm
from repro_torch.core import dac as tdac
from repro_torch.core import page_ref as tpr

C_IPP = 64
POLICIES = ("lru", "fifo", "lfu")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy().astype(np.float64)
    return np.asarray(x, np.float64)


def _t(a):
    return torch.as_tensor(a)


@pytest.fixture(scope="module")
def positions():
    rng = np.random.default_rng(0)
    # skewed ranks over 60 pages, ragged last page
    return np.sort(rng.zipf(1.3, 3000) % (60 * C_IPP - 17)).astype(np.int64)


def _probs(seed, p=400, zero_frac=0.3):
    rng = np.random.default_rng(seed)
    c = rng.pareto(1.2, p).astype(np.float32)
    c[rng.random(p) < zero_frac] = 0.0
    return (c / c.sum()).astype(np.float32)


# ---------------------------------------------------------------------------
# dac
# ---------------------------------------------------------------------------

def test_dac_closed_forms_and_mixture():
    eps = np.asarray([1, 8, 64, 1000, 4096], np.float64)
    for strategy in ("all_at_once", "one_by_one"):
        assert np.array_equal(
            _np(tdac.expected_dac(eps, C_IPP, strategy)),
            _np(jdac.expected_dac(eps, C_IPP, strategy)))
    with pytest.raises(ValueError):
        tdac.expected_dac(eps, C_IPP, "sideways")
    rng = np.random.default_rng(1)
    leaf_eps, w = rng.integers(0, 500, 300), rng.random(300)
    for strategy in ("all_at_once", "one_by_one"):
        assert abs(float(tdac.expected_dac_rmi(leaf_eps, w, C_IPP, strategy))
                   - float(jdac.expected_dac_rmi(leaf_eps, w, C_IPP,
                                                 strategy))) < 2e-6
    assert tdac.expected_dac_all_at_once_exact(37, C_IPP) == \
        jdac.expected_dac_all_at_once_exact(37, C_IPP)
    assert tdac.expected_dac_one_by_one_exact(37, C_IPP) == \
        jdac.expected_dac_one_by_one_exact(37, C_IPP)


# ---------------------------------------------------------------------------
# page_ref
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("eps", [1, 7, 64, 300])
def test_point_lut_and_histogram(positions, eps):
    # XLA folds the constant divisor into a reciprocal multiply: one
    # float32 ulp apart from a true division
    assert np.max(np.abs(_np(tpr.point_lut(eps, C_IPP))
                         - _np(jpr.point_lut(eps, C_IPP)))) < 2e-7
    num_pages = 60
    cj, tj = jpr.point_page_refs(jnp.asarray(positions, jnp.int32), eps,
                                 C_IPP, num_pages)
    ct, tt = tpr.point_page_refs(_t(positions), eps, C_IPP, num_pages)
    scale = max(1.0, float(np.max(cj)))
    assert np.max(np.abs(_np(cj) - _np(ct))) / scale < 2e-6
    assert abs(float(tj) - float(tt)) / max(float(tj), 1.0) < 2e-6


def test_point_and_range_grids(positions):
    num_pages, n = 60, 60 * C_IPP - 17
    eps_grid = np.asarray([2, 16, 40, 130], np.int64)
    d = jpr.lut_radius(int(eps_grid.max()), C_IPP)
    assert d == tpr.lut_radius(int(eps_grid.max()), C_IPP)
    cj, tj = jpr.point_page_refs_grid(jnp.asarray(positions, jnp.int32),
                                      jnp.asarray(eps_grid, jnp.int32), d,
                                      C_IPP, num_pages)
    ct, tt = tpr.point_page_refs_grid(_t(positions), _t(eps_grid), d, C_IPP,
                                      num_pages)
    scale = max(1.0, float(np.max(cj)))
    assert np.max(np.abs(_np(cj) - _np(ct))) / scale < 2e-6
    assert np.max(np.abs(_np(tj) - _np(tt)) / _np(tj)) < 2e-6
    rng = np.random.default_rng(3)
    lo = rng.integers(0, n - 200, 500)
    hi = lo + rng.integers(0, 200, 500)
    rj, rtj = jpr.range_page_refs_grid(jnp.asarray(lo, jnp.int32),
                                       jnp.asarray(hi, jnp.int32),
                                       jnp.asarray(eps_grid, jnp.int32),
                                       C_IPP, num_pages, n)
    rt, rtt = tpr.range_page_refs_grid(_t(lo), _t(hi), _t(eps_grid), C_IPP,
                                       num_pages, n)
    assert np.array_equal(_np(rj), _np(rt))             # integer mass
    assert np.array_equal(_np(rtj), _np(rtt))
    for e in (0, 16):
        a, b = jpr.range_page_refs(jnp.asarray(lo, jnp.int32),
                                   jnp.asarray(hi, jnp.int32), e, C_IPP,
                                   num_pages, n)
        c, t = tpr.range_page_refs(_t(lo), _t(hi), e, C_IPP, num_pages, n)
        assert np.array_equal(_np(a), _np(c)) and float(b) == float(t)


def test_mixed_eps_host_kernel_and_per_branch_path(positions):
    num_pages = 60
    rng = np.random.default_rng(4)
    eps_rows = rng.choice([1, 2, 8, 64], size=(3, positions.shape[0]))
    ch, th = jpr.point_page_refs_mixed_eps_grid(positions, eps_rows, C_IPP,
                                                num_pages)
    ct, tt = tpr.point_page_refs_mixed_eps_grid(positions, eps_rows, C_IPP,
                                                num_pages)
    assert np.array_equal(np.asarray(ch), ct) and np.array_equal(th, tt)
    codes_j, cls_j = jpr.mixed_eps_class_codes(np.asarray([3, 5, 12, 3]))
    codes_t, cls_t = tpr.mixed_eps_class_codes(np.asarray([3, 5, 12, 3]))
    assert np.array_equal(codes_j, codes_t) and np.array_equal(cls_j, cls_t)
    mj, mtj = jpr.point_page_refs_mixed_eps(positions, eps_rows[0], C_IPP,
                                            num_pages)
    mt, mtt = tpr.point_page_refs_mixed_eps(positions, eps_rows[0], C_IPP,
                                            num_pages)
    scale = max(1.0, float(np.max(mj)))
    assert np.max(np.abs(_np(mj) - _np(mt))) / scale < 2e-6
    assert abs(float(mtj) - float(mtt)) / max(float(mtj), 1.0) < 2e-6


def test_sorted_stream_statistics():
    rng = np.random.default_rng(6)
    num_pages = 80
    lo = np.sort(rng.integers(-20, num_pages * C_IPP, 700))
    hi = lo + rng.integers(0, 3 * C_IPP, 700)
    pj = jpr.page_intervals(jnp.asarray(lo, jnp.int32),
                            jnp.asarray(hi, jnp.int32), C_IPP, num_pages)
    pt = tpr.page_intervals(_t(lo), _t(hi), C_IPP, num_pages)
    for a, b in zip(pj, pt):
        assert np.array_equal(np.asarray(a), b.numpy())
    rn_j = jpr.sorted_workload_rn(*pj)
    rn_t = tpr.sorted_workload_rn(*pt)
    assert [float(x) for x in rn_j] == [float(x) for x in rn_t]
    st_j = jpr.sorted_workload_stats(*pj, num_pages)
    st_t = tpr.sorted_workload_stats(*pt, num_pages)
    for a, b in zip(st_j, st_t):
        assert np.array_equal(_np(a), _np(b))


# ---------------------------------------------------------------------------
# cache_models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("cap", [1, 7, 60, 250])
def test_hit_rate_single_candidate(policy, cap):
    p = _probs(cap)
    nd = float((p > 0).sum())
    hj = float(jcm.hit_rate(policy, cap, jnp.asarray(p),
                            total_requests=5000.0))
    ht = float(tcm.hit_rate(policy, cap, _t(p), total_requests=5000.0))
    assert abs(hj - ht) < 2e-6, (hj, ht)
    if cap < nd and policy != "lfu":
        solve_j = jcm.solve_che_time if policy == "lru" else jcm.solve_fifo_tau
        solve_t = tcm.solve_che_time if policy == "lru" else tcm.solve_fifo_tau
        tj = float(solve_j(jnp.asarray(p), cap))
        tt = float(solve_t(_t(p), cap))
        assert abs(tj - tt) / tj < 1e-5


def test_hit_rate_lru_kernel_path_raises():
    with pytest.raises(NotImplementedError, match="che_sums"):
        tcm.hit_rate_lru(_t(_probs(0)), 8, use_kernel=True)


@pytest.mark.parametrize("policy", POLICIES)
def test_writeback_with_tied_lfu_probabilities(policy):
    """Many equal combined probabilities with DIFFERENT write shares: the
    LFU resident set's write mass depends on the tie order, which both
    packages must break as a stable descending sort does."""
    rng = np.random.default_rng(7)
    counts = np.repeat(np.asarray([8.0, 4.0, 4.0, 2.0]), 50).astype(np.float32)
    writes = np.floor(counts * rng.random(counts.shape[0])).astype(np.float32)
    probs = counts / counts.sum()
    wprobs = writes / counts.sum()
    for cap in (0, 1, 30, 75, 120, 199, 250):
        wj = float(jcm.writeback_fraction(policy, jnp.asarray(probs),
                                          jnp.asarray(wprobs), cap))
        wt = float(tcm.writeback_fraction(policy, _t(probs), _t(wprobs), cap))
        assert abs(wj - wt) < 2e-6, (cap, wj, wt)
        if policy == "lfu" and 0 < cap < 200:
            bj = float(jcm._writeback_terms(
                "lfu", jnp.asarray(probs), jnp.asarray(wprobs), float(cap)))
            bt = float(tcm._writeback_terms("lfu", _t(probs), _t(wprobs),
                                            float(cap)))
            assert abs(bj - bt) < 2e-6, cap
    with pytest.raises(ValueError):
        tcm._writeback_terms("arc", _t(probs), _t(wprobs), 4.0)


@pytest.mark.parametrize("policy", POLICIES)
def test_sorted_scan_family(policy):
    rng = np.random.default_rng(8)
    cov = rng.integers(0, 5, 300).astype(np.float32)
    r, n = float(cov.sum()), float((cov > 0).sum())
    kw = dict(total_refs=r, distinct_pages=n, pinned_retouches=40.0,
              min_capacity=4)
    for cap in (2, 4, 50, 150, int(n), 400):
        mj = jcm.sorted_scan_misses(policy, cap, coverage=jnp.asarray(cov),
                                    **kw)
        mt = tcm.sorted_scan_misses(policy, cap, coverage=_t(cov), **kw)
        assert abs(mj - mt) <= 2e-6 * r
        hj = jcm.sorted_scan_hit_rate(policy, cap, coverage=jnp.asarray(cov),
                                      **kw)
        ht = tcm.sorted_scan_hit_rate(policy, cap, coverage=_t(cov), **kw)
        assert abs(hj - ht) < 2e-6
    caps = np.asarray([1, 3, 4, 40, 160, 2**25], np.int64)
    cj = jcm.sorted_scan_miss_curve(policy, jnp.asarray(caps, jnp.int32),
                                    coverage=jnp.asarray(cov), **kw)
    ct = tcm.sorted_scan_miss_curve(policy, _t(caps), coverage=_t(cov), **kw)
    assert np.max(np.abs(_np(cj) - _np(ct))) <= 2e-6 * r
    k = caps.shape[0]
    covs = np.stack([cov, np.roll(cov, 3)] * 3)[:k]
    for shared in (True, False):
        c_arg = cov if shared else covs
        args = (np.full(k, r, np.float32), np.full(k, n, np.float32),
                np.full(k, 40.0, np.float32), caps, np.full(k, 4, np.int64))
        gj = jcm.sorted_scan_hit_rate_grid(
            policy, jnp.asarray(c_arg), *[jnp.asarray(a) for a in args[:3]],
            jnp.asarray(caps, jnp.int32), jnp.asarray(args[4], jnp.int32))
        gt = tcm.sorted_scan_hit_rate_grid(policy, _t(c_arg),
                                           *[_t(a) for a in args])
        assert np.max(np.abs(_np(gj) - _np(gt))) < 2e-6


def _grid_inputs(k=6, p=350, seed=9):
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 7, (k, p)).astype(np.float32)
    counts[:, rng.random(p) < 0.25] = 0.0
    sample = counts.sum(1).astype(np.float32)
    nd = (counts > 0).sum(1)
    caps = np.asarray([0, 1, 9, int(nd[3]) // 2, int(nd[4]), 2**25][:k],
                      np.int64)
    return counts, sample, caps


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("parts", ["irm", "sorted", "write", "both"])
def test_hit_rate_grid(policy, parts):
    counts, sample, caps = _grid_inputs()
    k, p = counts.shape
    full = sample * np.float32(2.5)
    kw_j, kw_t = {}, {}
    rng = np.random.default_rng(10)
    if parts in ("sorted", "both"):
        cov = rng.integers(0, 3, (k, p)).astype(np.float32)
        s = dict(sorted_coverage=cov, sorted_refs=cov.sum(1),
                 sorted_distinct=(cov > 0).sum(1).astype(np.int32),
                 sorted_pinned=np.full(k, 5.0, np.float32),
                 sorted_min_caps=np.full(k, 3, np.int32),
                 sorted_full_refs=cov.sum(1) * np.float32(2.5))
        kw_j.update({a: jnp.asarray(v) for a, v in s.items()})
        kw_t.update({a: _t(v) for a, v in s.items()})
    if parts in ("write", "both"):
        wc = np.floor(counts * rng.random((k, p))).astype(np.float32)
        w = dict(write_counts=wc, write_refs=wc.sum(1),
                 write_full_refs=wc.sum(1) * np.float32(2.5))
        kw_j.update({a: jnp.asarray(v) for a, v in w.items()})
        kw_t.update({a: _t(v) for a, v in w.items()})
    hj, nj = jcm.hit_rate_grid(policy, jnp.asarray(counts),
                               jnp.asarray(sample), jnp.asarray(full),
                               jnp.asarray(caps, jnp.int32), **kw_j)
    ht, nt = tcm.hit_rate_grid(policy, _t(counts), _t(sample), _t(full),
                               _t(caps.astype(np.int32)), **kw_t)
    assert np.max(np.abs(_np(hj) - _np(ht))) < 2e-6
    assert np.array_equal(_np(nj), _np(nt))
    curve_j = jcm.hit_rate_curve(policy, jnp.asarray(counts[2]),
                                 float(sample[2]), float(full[2]),
                                 jnp.asarray(caps, jnp.int32))
    curve_t = tcm.hit_rate_curve(policy, _t(counts[2]), float(sample[2]),
                                 float(full[2]), _t(caps))
    assert np.max(np.abs(_np(curve_j) - _np(curve_t))) < 2e-6


@pytest.mark.parametrize("policy", POLICIES)
def test_hit_rate_grid_capacity_flip_above_2_24(policy):
    """cap = 2^24 + 1 vs N = 2^24 + 1 distinct pages would round equal in
    float32; the int32 compare keeps the compulsory branch exact."""
    n_d = 2**24 + 1
    counts = np.zeros((2, 8), np.float32)
    counts[:, :4] = 1.0
    caps = np.asarray([n_d - 1, n_d], np.int64)
    s = dict(sorted_coverage=np.full((2, 8), 2.0, np.float32),   # R=16
             sorted_refs=np.full(2, 16.0, np.float32),
             sorted_distinct=np.full(2, 8, np.int32),
             sorted_pinned=np.zeros(2, np.float32),
             sorted_min_caps=np.full(2, n_d, np.int32),
             sorted_full_refs=np.full(2, 16.0, np.float32))
    hj, _ = jcm.hit_rate_grid(policy, jnp.asarray(counts),
                              jnp.full(2, 4.0), jnp.full(2, 4.0),
                              jnp.asarray(caps, jnp.int32),
                              **{a: jnp.asarray(v) for a, v in s.items()})
    ht, _ = tcm.hit_rate_grid(policy, _t(counts), torch.full((2,), 4.0),
                              torch.full((2,), 4.0),
                              _t(caps.astype(np.int32)),
                              **{a: _t(v) for a, v in s.items()})
    assert np.array_equal(_np(hj), _np(ht))
    assert _np(ht)[0] != _np(ht)[1]                      # thrash vs modeled
    assert np.array_equal(_np(tcm._exact_caps(caps)),
                          np.asarray(jcm._exact_caps(jnp.asarray(
                              caps, jnp.int32))))
