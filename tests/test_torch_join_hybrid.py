"""The port's join building blocks vs the JAX reference (CPU).

Algorithm 2's partitioning, the Eq. 17 calibration against the simulated
machine, the buffered-disk replay, the LPM baseline and the paper's
§VII-A constants are numpy code in both packages, so the port is held to
them exactly: segments field for field, miss counts ``array_equal``, the
calibrated coefficients at rtol 1e-12 and LPM at 1e-12.
"""
import dataclasses

import numpy as np
import pytest

from repro.configs import cam_paper as jpaper
from repro.core import lpm as jlpm
from repro.core.cam import CamGeometry as JGeom
from repro.core.session import System as JSystem
from repro.data.datasets import make_dataset
from repro.index.adapters import PGMAdapter as JPGM
from repro.index.disk_layout import PageLayout as JLayout
from repro.join import calibrate as jcal
from repro.join import hybrid as jhy
from repro.sim import machine as jsim
from repro_torch.configs import cam_paper as tpaper
from repro_torch.core import lpm as tlpm
from repro_torch.core.cam import CamGeometry
from repro_torch.core.session import System
from repro_torch.index.adapters import PGMAdapter
from repro_torch.index.disk_layout import PageLayout
from repro_torch.join import calibrate as tcal
from repro_torch.join import hybrid as thy
from repro_torch.sim import machine as tsim

POLICIES = ("lru", "fifo", "lfu")
#: tests/test_join_session.py's golden seeds for Algorithm 2
GOLDEN = [(0, 64, 512, False), (1, 1024, 8192, False), (2, 128, 4096, True),
          (3, 17, 100, False), (4, 1, 10**9, False)]
CAL_RTOL = 1e-12


def _rows(segments):
    return [dataclasses.astuple(s) for s in segments]


def _golden_stream(seed):
    rng = np.random.default_rng(seed)
    lo = np.sort(rng.integers(0, 50_000, size=20_000))
    return lo, lo + rng.integers(0, 4, size=20_000)


@pytest.fixture(scope="module")
def inner():
    keys = make_dataset("books", 200_000, seed=5)
    return keys, JPGM.build(keys, eps=32), PGMAdapter.build(keys, eps=32)


# ---------------------------------------------------------------------------
# Algorithm 2
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,n_min,k_max,thrash", GOLDEN)
def test_partition_probes_equal_to_jax(seed, n_min, k_max, thrash):
    lo, hi = _golden_stream(seed)
    kw = dict(n_min=n_min, k_max=k_max, thrash=thrash)
    got = thy.partition_probes(lo, hi, thy.JoinCostParams(), **kw)
    want = jhy.partition_probes(lo, hi, jhy.JoinCostParams(), **kw)
    assert _rows(got) == _rows(want)          # exact, segment for segment


@pytest.mark.parametrize("seed,n_min,k_max,thrash", GOLDEN)
def test_partition_probes_loop_equal_to_jax(seed, n_min, k_max, thrash):
    lo, hi = _golden_stream(seed)
    kw = dict(n_min=n_min, k_max=k_max, thrash=thrash)
    got = thy.partition_probes_loop(lo, hi, thy.JoinCostParams(), **kw)
    want = jhy.partition_probes_loop(lo, hi, jhy.JoinCostParams(), **kw)
    assert _rows(got) == _rows(want)          # exact
    # and the port's vectorized pass equals its own loop
    assert _rows(thy.partition_probes(lo, hi, thy.JoinCostParams(),
                                      **kw)) == _rows(got)


@pytest.mark.parametrize("stream", ("dense", "sparse"))
def test_partition_probes_dense_and_sparse_equal_to_jax(stream):
    w = (np.repeat(np.arange(200), 40) if stream == "dense"
         else np.arange(0, 3_000_000, 5000))
    kw = dict(n_min=64, k_max=10**9)
    assert _rows(thy.partition_probes(w, w, thy.JoinCostParams(), **kw)) \
        == _rows(jhy.partition_probes(w, w, jhy.JoinCostParams(), **kw))


def test_cost_params_and_segment_costs_equal_to_jax():
    assert dataclasses.asdict(thy.JoinCostParams()) \
        == dataclasses.asdict(jhy.JoinCostParams())
    assert dataclasses.asdict(tsim.MachineParams()) \
        == dataclasses.asdict(jsim.MachineParams())
    tp, jp = thy.JoinCostParams(alpha=2e-6), jhy.JoinCostParams(alpha=2e-6)
    for n, d, span in ((1, 1, 1), (1024, 37, 400), (10**6, 5000, 20_000)):
        assert thy.segment_costs(n, d, span, tp) \
            == jhy.segment_costs(n, d, span, jp)  # exact


# ---------------------------------------------------------------------------
# Calibration against the simulated machine
# ---------------------------------------------------------------------------

def _assert_params_close(got, want):
    g, w = dataclasses.asdict(got), dataclasses.asdict(want)
    assert g.keys() == w.keys()
    for name in w:
        np.testing.assert_allclose(g[name], w[name], rtol=CAL_RTOL, atol=0,
                                   err_msg=name)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("seed", (0, 3))
def test_calibrate_system_equal_to_jax(inner, policy, seed):
    keys, jidx, tidx = inner
    assert tidx.size_bytes == jidx.size_bytes
    budget = (2 << 20) + tidx.size_bytes
    got = tcal.calibrate_system(
        tidx, keys, System(CamGeometry(), budget, policy, torch_device="cpu"),
        seed=seed)
    want = jcal.calibrate_system(jidx, keys, JSystem(JGeom(), budget, policy),
                                 seed=seed)
    _assert_params_close(got, want)          # rtol 1e-12


@pytest.mark.parametrize("capacity", (1, 64, 4096))
def test_legacy_calibrate_equal_to_jax(inner, capacity):
    keys, jidx, tidx = inner
    machine = dict(cpu_per_key=2e-6, miss_latency_point=9e-6)
    got = tcal.calibrate(tidx, keys, PageLayout(), capacity, "fifo",
                         tsim.MachineParams(**machine), seed=1)
    want = jcal.calibrate(jidx, keys, JLayout(), capacity, "fifo",
                          jsim.MachineParams(**machine), seed=1)
    _assert_params_close(got, want)          # rtol 1e-12


# ---------------------------------------------------------------------------
# The buffered disk and the point-query simulation
# ---------------------------------------------------------------------------

def _windows(seed, n=3_000, pages=700):
    rng = np.random.default_rng(seed)
    lo = rng.integers(0, pages, n)
    hi = np.minimum(lo + rng.integers(0, 5, n), pages - 1)
    return lo, hi


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("capacity", (1, 50, 400))
def test_buffered_disk_misses_equal_to_jax(policy, capacity):
    lo, hi = _windows(capacity)
    tdisk = tsim.BufferedDisk(700, capacity, policy)
    jdisk = jsim.BufferedDisk(700, capacity, policy)
    got = np.array([tdisk.fetch_window(int(a), int(b)) for a, b in zip(lo, hi)])
    want = np.array([jdisk.fetch_window(int(a), int(b))
                     for a, b in zip(lo, hi)])
    np.testing.assert_array_equal(got, want)                       # exact
    assert (tdisk.physical_reads, tdisk.logical_reads) \
        == (jdisk.physical_reads, jdisk.logical_reads)


@pytest.mark.parametrize("policy", POLICIES)
def test_simulate_point_queries_equal_to_jax(policy):
    lo, hi = _windows(11)
    got = tsim.simulate_point_queries(lo, hi, 120, policy)
    want = jsim.simulate_point_queries(lo, hi, 120, policy)
    assert got[2] == want[2]                  # total misses, exact
    assert got[:2] == want[:2]                # same float arithmetic, exact


# ---------------------------------------------------------------------------
# LPM and the paper's constants
# ---------------------------------------------------------------------------

def test_lpm_equal_to_jax():
    lo, hi = _windows(5)
    np.testing.assert_allclose(tlpm.lpm_estimate_from_windows(lo, hi),
                               jlpm.lpm_estimate_from_windows(lo, hi),
                               rtol=1e-12, atol=0)
    assert tlpm.lpm_estimate_from_windows(lo[:0], hi[:0]) == 0.0
    for eps in (1, 16, 64, 256, 1024):
        for strategy in ("all_at_once", "one_by_one"):
            np.testing.assert_allclose(
                tlpm.lpm_estimate_analytic(eps, 256, strategy),
                jlpm.lpm_estimate_analytic(eps, 256, strategy),
                rtol=1e-12, atol=0, err_msg=f"eps={eps} {strategy}")


def test_cam_paper_constants_equal_to_jax():
    for name in ("PAPER", "SCALED_DEFAULT"):
        assert dataclasses.asdict(getattr(tpaper, name)) \
            == dataclasses.asdict(getattr(jpaper, name)), name
    assert tpaper.PAPER.scale_factor(20_000_000) == 10.0
    assert tpaper.PAPER.join_buffer_bytes == 16 * 2**20
