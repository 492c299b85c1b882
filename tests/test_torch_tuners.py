"""The port's deprecated tuner shims (``repro_torch.tuning.{pgm_tuner,
rmi_tuner,rs_tuner}``) against the port's own ``TuningSession`` and
against the JAX package's shims, on the CPU.

* Against the port's session (the mirror of the JAX golden tests in
  ``tests/test_tuning_session.py``): the same knob, ``est_io`` within 1e-9,
  the baselines' knobs equal.
* Against JAX's shims, both packages given the same fitted size model
  (``fit_power_law`` moves by up to ~5e-3 on a one-ulp input change, a
  held divergence): the same knob and capacity, ``est_io`` and every
  estimate within rtol 1e-5, the built RMIs equal.
* Each shim warns ``DeprecationWarning`` naming ``repro_torch``, attributed
  to its caller; under this file's gate a call from a ``repro_torch.``
  module is an error, and no port module calls a shim outside a scoped
  ``warnings.catch_warnings``.
"""
import ast
import dataclasses
import pathlib
import types
import warnings

import numpy as np
import pytest

from repro.core.cam import CamGeometry as JGeom
from repro.data.datasets import make_dataset
from repro.data.workloads import WorkloadSpec, point_workload
from repro.index.rmi import build_rmi as jbuild_rmi
from repro.tuning import fit as jfit
from repro.tuning import pgm_tuner as jpgm
from repro.tuning import rmi_tuner as jrmi
from repro.tuning import rs_tuner as jrs
from repro_torch.core.cam import CamGeometry
from repro_torch.core.session import System
from repro_torch.core.workload import Workload
from repro_torch.index.rmi import build_rmi
from repro_torch.tuning import fit as tfit
from repro_torch.tuning import pgm_tuner, rmi_tuner, rs_tuner
from repro_torch.tuning.session import (CDFShopTuner, MulticriteriaTuner,
                                        PGMBuilder, RadixSplineBuilder,
                                        RMIBuilder, TuningSession)

pytestmark = pytest.mark.filterwarnings(
    "error::DeprecationWarning:repro_torch\\..*")

ROOT = pathlib.Path(__file__).resolve().parents[1]
GEOM, JGEOM = CamGeometry(), JGeom()
BUDGET = 1 << 20
EPS_GRID = (16, 64, 256, 1024)
BRANCH_GRID = (256, 1024, 4096)
CPU = dict(torch_device="cpu")
SHIMS = {"pgm_tuner": ("profile_pgm_size_model", "cam_tune_uniform_eps",
                       "cam_tune_pgm", "multicriteria_pgm_tune"),
         "rmi_tuner": ("estimate_rmi_io", "cam_tune_rmi",
                       "cdfshop_tune_rmi"),
         "rs_tuner": ("profile_radixspline_size_model",
                      "cam_tune_radixspline")}
SHIM_NAMES = {f for fns in SHIMS.values() for f in fns} | {
    "estimate_point_io", "estimate_range_io", "estimate_sorted_io"}


@pytest.fixture(scope="module")
def world():
    keys = make_dataset("books", 200_000, seed=1)
    qk, qpos = point_workload(keys, 20_000, WorkloadSpec("w4", seed=3))
    return keys, qk, qpos


@pytest.fixture
def shared_fit(monkeypatch):
    """The port's power-law fits go through the JAX fit: both packages
    price the same fitted curves (and the jitted fit is the quicker)."""
    def fit(xs, ys, **kw):
        return tfit.PowerLawFit(**dataclasses.asdict(
            jfit.fit_power_law(xs, ys, **kw)))

    monkeypatch.setattr(tfit, "fit_power_law", fit)


# ---------------------------------------------------------------------------
# The shims against the port's own session
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy", ["lru", "fifo", "lfu"])
def test_shims_reproduce_session_choices(world, shared_fit, policy):
    keys, qk, qpos = world
    ts = TuningSession(System(GEOM, BUDGET, policy, **CPU))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        legacy_pgm = pgm_tuner.cam_tune_pgm(keys, qpos, BUDGET, GEOM, policy,
                                            eps_grid=EPS_GRID, **CPU)
        legacy_rmi = rmi_tuner.cam_tune_rmi(keys, qpos, qk, BUDGET, GEOM,
                                            policy, branch_grid=BRANCH_GRID,
                                            **CPU)
        legacy_rs = rs_tuner.cam_tune_radixspline(
            keys, qpos, BUDGET, GEOM, policy, eps_grid=EPS_GRID,
            radix_bits=10, **CPU)
    res_pgm = ts.tune(PGMBuilder(keys), Workload.point(qpos, n=len(keys)),
                      overrides={"eps": EPS_GRID})
    assert legacy_pgm.best_eps == res_pgm.best_knob
    assert abs(legacy_pgm.est_io - res_pgm.est_io) < 1e-9

    wl = Workload.point(qpos, n=len(keys), query_keys=qk)
    res_rmi = ts.tune(RMIBuilder(keys), wl,
                      overrides={"branch": BRANCH_GRID})
    assert legacy_rmi.best_branch == res_rmi.best_knob
    assert abs(legacy_rmi.est_io - res_rmi.est_io) < 1e-9
    assert legacy_rmi.best_branch in legacy_rmi.indexes

    res_rs = ts.tune(RadixSplineBuilder(keys, ref_radix_bits=10),
                     Workload.point(qpos, n=len(keys)),
                     overrides={"eps": EPS_GRID, "radix_bits": 10})
    assert legacy_rs.best_eps == res_rs.best["eps"]
    assert abs(legacy_rs.est_io - res_rs.est_io) < 1e-9
    assert set(legacy_rs.estimates) == set(EPS_GRID)


def test_baseline_shims_match_session_strategies(world):
    keys, qk, qpos = world
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        eps, _ = pgm_tuner.multicriteria_pgm_tune(
            keys, index_space_budget=BUDGET // 2, eps_grid=EPS_GRID, **CPU)
        branch, _, built = rmi_tuner.cdfshop_tune_rmi(
            keys, BUDGET // 2, branch_grid=BRANCH_GRID, **CPU)
    wl = Workload.point(qpos, n=len(keys), query_keys=qk)
    ts = TuningSession(System(GEOM, BUDGET, "lru", **CPU))
    res = ts.tune(PGMBuilder(keys), wl, tuner=MulticriteriaTuner(),
                  overrides={"eps": EPS_GRID})
    assert res.best_knob == eps and res.tuner == "multicriteria"
    res2 = ts.tune(RMIBuilder(keys), wl, tuner=CDFShopTuner(),
                   overrides={"branch": BRANCH_GRID})
    assert res2.best_knob == branch and res2.tuner == "cdfshop"
    assert branch in built


# ---------------------------------------------------------------------------
# The shims against JAX's shims
# ---------------------------------------------------------------------------

def _estimates_close(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        assert g.capacity_pages == w.capacity_pages, k
        assert g.io_per_query == pytest.approx(w.io_per_query, rel=1e-5), k
        assert abs(g.hit_rate - w.hit_rate) <= 2e-6, k


@pytest.mark.parametrize("policy", ["lru", "fifo", "lfu"])
def test_shims_match_jax(world, shared_fit, policy):
    keys, qk, qpos = world
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        pairs = [
            (pgm_tuner.cam_tune_pgm(keys, qpos, BUDGET, GEOM, policy,
                                    eps_grid=EPS_GRID, **CPU),
             jpgm.cam_tune_pgm(keys, qpos, BUDGET, JGEOM, policy,
                               eps_grid=EPS_GRID), "best_eps"),
            (rmi_tuner.cam_tune_rmi(keys, qpos, qk, BUDGET, GEOM, policy,
                                    branch_grid=BRANCH_GRID, **CPU),
             jrmi.cam_tune_rmi(keys, qpos, qk, BUDGET, JGEOM, policy,
                               branch_grid=BRANCH_GRID), "best_branch"),
            (rs_tuner.cam_tune_radixspline(keys, qpos, BUDGET, GEOM, policy,
                                           eps_grid=EPS_GRID, radix_bits=10,
                                           **CPU),
             jrs.cam_tune_radixspline(keys, qpos, BUDGET, JGEOM, policy,
                                      eps_grid=EPS_GRID, radix_bits=10),
             "best_eps")]
    for got, want, knob in pairs:
        assert getattr(got, knob) == getattr(want, knob), knob
        best = getattr(got, knob)
        assert got.estimates[best].capacity_pages \
            == want.estimates[best].capacity_pages
        assert got.est_io == pytest.approx(want.est_io, rel=1e-5)
        _estimates_close(got.estimates, want.estimates)
    got_rmi, want_rmi = pairs[1][0], pairs[1][1]
    assert set(got_rmi.indexes) == set(want_rmi.indexes)
    for b, idx in want_rmi.indexes.items():
        assert got_rmi.indexes[b].size_bytes == idx.size_bytes
        np.testing.assert_array_equal(got_rmi.indexes[b].leaf_eps,
                                      idx.leaf_eps)


def test_baselines_size_models_and_estimates_match_jax(world, shared_fit):
    keys, qk, qpos = world
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        assert pgm_tuner.multicriteria_pgm_tune(
            keys, BUDGET // 2, eps_grid=EPS_GRID, **CPU)[0] \
            == jpgm.multicriteria_pgm_tune(keys, BUDGET // 2,
                                           eps_grid=EPS_GRID)[0]
        # the legacy profile-free mode
        assert pgm_tuner.multicriteria_pgm_tune(
            keys, 20_000, profile_lookups=0, **CPU)[0] \
            == jpgm.multicriteria_pgm_tune(keys, 20_000, profile_lookups=0)[0]
        tb, _, tbuilt = rmi_tuner.cdfshop_tune_rmi(
            keys, BUDGET // 2, branch_grid=BRANCH_GRID, **CPU)
        jb, _, jbuilt = jrmi.cdfshop_tune_rmi(keys, BUDGET // 2,
                                              branch_grid=BRANCH_GRID)
        assert tb == jb and set(tbuilt) == set(jbuilt)

        t_fit, _ = pgm_tuner.profile_pgm_size_model(keys)
        j_fit, _ = jpgm.profile_pgm_size_model(keys)
        assert dataclasses.astuple(t_fit) == dataclasses.astuple(j_fit)
        t_rs, _ = rs_tuner.profile_radixspline_size_model(keys,
                                                          radix_bits=12)
        j_rs, _ = jrs.profile_radixspline_size_model(keys, radix_bits=12)
        assert dataclasses.astuple(t_rs) == dataclasses.astuple(j_rs)

        system = System(GEOM, BUDGET, "fifo", **CPU)
        from repro.core.session import System as JSystem
        from repro.core.workload import Workload as JW
        t_best, t_est, _ = pgm_tuner.cam_tune_uniform_eps(
            Workload.point(qpos, n=len(keys)), t_fit, system, EPS_GRID)
        j_best, j_est, _ = jpgm.cam_tune_uniform_eps(
            JW.point(qpos, n=len(keys)), j_fit,
            JSystem(JGEOM, BUDGET, "fifo"), EPS_GRID)
        assert t_best == j_best
        _estimates_close(t_est, j_est)

        got = rmi_tuner.estimate_rmi_io(build_rmi(keys, 1024), qpos, qk,
                                        GEOM, BUDGET, "lfu", **CPU)
        want = jrmi.estimate_rmi_io(jbuild_rmi(keys, 1024), qpos, qk, JGEOM,
                                    BUDGET, "lfu")
        _estimates_close({0: got}, {0: want})
    assert pgm_tuner.default_eps_grid() == jpgm.default_eps_grid()
    assert rmi_tuner.default_branch_grid() == jrmi.default_branch_grid()


# ---------------------------------------------------------------------------
# The deprecation warnings and the gate
# ---------------------------------------------------------------------------

def _calls(keys, qk, qpos):
    rmi = build_rmi(keys[:20_000], 256)
    return {
        "profile_pgm_size_model": lambda: pgm_tuner.profile_pgm_size_model(
            keys[:20_000]),
        "cam_tune_uniform_eps": lambda: pgm_tuner.cam_tune_uniform_eps(
            Workload.point(qpos, n=len(keys)), tfit.PowerLawFit(1e5, 1.0, 0),
            System(GEOM, BUDGET, "lru", **CPU), (64,)),
        "cam_tune_pgm": lambda: pgm_tuner.cam_tune_pgm(
            keys, qpos, BUDGET, GEOM, eps_grid=(64,), sample_eps=(16, 64),
            **CPU),
        "multicriteria_pgm_tune": lambda: pgm_tuner.multicriteria_pgm_tune(
            keys, BUDGET, eps_grid=(64,), profile_lookups=0, **CPU),
        "estimate_rmi_io": lambda: rmi_tuner.estimate_rmi_io(
            rmi, qpos[qpos < 20_000], qk[qpos < 20_000], GEOM, BUDGET,
            **CPU),
        "cam_tune_rmi": lambda: rmi_tuner.cam_tune_rmi(
            keys, qpos, qk, BUDGET, GEOM, branch_grid=(256,), **CPU),
        "cdfshop_tune_rmi": lambda: rmi_tuner.cdfshop_tune_rmi(
            keys, BUDGET, branch_grid=(256,), profile_lookups=100, **CPU),
        "profile_radixspline_size_model":
            lambda: rs_tuner.profile_radixspline_size_model(keys[:20_000]),
        "cam_tune_radixspline": lambda: rs_tuner.cam_tune_radixspline(
            keys, qpos, BUDGET, GEOM, eps_grid=(64,), radix_bits=10,
            **CPU),
    }


def test_each_shim_warns_naming_the_port_at_its_caller(world, shared_fit):
    calls = _calls(*world)
    assert set(calls) == {f for fns in SHIMS.values() for f in fns}
    for name, call in calls.items():
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            call()
        dep = [w for w in seen if issubclass(w.category, DeprecationWarning)]
        assert len(dep) == 1, (name, [str(w.message) for w in seen])
        assert "repro_torch" in str(dep[0].message), name
        assert name in str(dep[0].message), name
        # stacklevel points the warning at this caller, not the shim
        assert dep[0].filename == __file__, (name, dep[0].filename)


def test_a_call_from_a_port_module_is_an_error_under_the_gate(world):
    keys, qk, qpos = world
    probe = types.ModuleType("repro_torch._shim_probe")
    exec(compile(
        "from repro_torch.tuning import pgm_tuner, rs_tuner\n"
        "def call(keys):\n"
        "    return pgm_tuner.profile_pgm_size_model(keys)\n"
        "def call_rs(keys):\n"
        "    return rs_tuner.profile_radixspline_size_model(keys)\n",
        "<repro_torch._shim_probe>", "exec"), probe.__dict__)
    with pytest.raises(DeprecationWarning, match="repro_torch"):
        probe.call(keys[:20_000])
    with pytest.raises(DeprecationWarning, match="repro_torch"):
        probe.call_rs(keys[:20_000])
    # from a test module the same call only warns
    with pytest.warns(DeprecationWarning, match="repro_torch"):
        pgm_tuner.profile_pgm_size_model(keys[:20_000])


def _unscoped_shim_calls(path):
    """Calls of a shim by name in ``path`` that no ``with
    warnings.catch_warnings()`` block encloses."""
    tree = ast.parse(path.read_text())
    scoped = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.With) and any(
                isinstance(it.context_expr, ast.Call)
                and ast.unparse(it.context_expr.func).endswith(
                    "catch_warnings") for it in node.items):
            scoped.update(id(n) for n in ast.walk(node))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and id(node) not in scoped:
            name = ast.unparse(node.func).split(".")[-1]
            if name in SHIM_NAMES:
                bad.append(f"{path.name}:{node.lineno} {name}")
    return bad


def test_no_port_module_calls_a_shim_outside_catch_warnings():
    pkg = ROOT / "src" / "repro_torch"
    shim_files = {pkg / "tuning" / f"{m}.py" for m in SHIMS} | {
        pkg / "core" / "cam.py"}
    bad = [b for path in sorted(pkg.rglob("*.py")) if path not in shim_files
           for b in _unscoped_shim_calls(path)]
    assert not bad, bad
    # the three twins that call a shim on purpose do so inside the scope
    launch = pkg / "launch"
    for twin in ("bench_point_accuracy", "bench_range_accuracy",
                 "bench_estimate_grid"):
        text = (launch / f"{twin}.py").read_text()
        assert "catch_warnings" in text and "estimate_" in text, twin
