"""The port's twins of the paper's accuracy tables, tuning curves, grid
benchmark and kernel benchmark against the JAX package's scripts, on the
CPU: Table IV (``bench_point_accuracy``), Table V
(``bench_range_accuracy``), Table I (``bench_io_size``), Table II
(``bench_covariance``), Fig 5 (``bench_fetch_strategy``), Figs 7 and 8
(``bench_{pgm,rmi}_tuning_curve``), the grid against the legacy loop
(``bench_estimate_grid``) and the Che solver (``bench_kernels``).

Both sides run at ``benchmarks/run.py``'s ``--smoke`` size (200,000 keys,
20,000 queries; the tables on one dataset and one workload), the port with
``torch_device="cpu"``.  Bounds: every q-error's replayed I/O exact and
its estimate within rtol 1e-5 or 2e-6 E[DAC] (the held divergence where h
is within float32 ulps of 1); chosen knobs exact; the numpy-only tables'
printed lines equal; estimates within rtol 1e-5; the Che solver's T
within 1e-4 (the solver's CPU parity bound).  No timing is compared.
"""
import io
from contextlib import redirect_stdout

import numpy as np
import pytest

from _torch_paper import assert_same, csv_rows, fields, logged, share_fit
from benchmarks import bench_covariance as jcov
from benchmarks import bench_estimate_grid as jeg
from benchmarks import bench_fetch_strategy as jfetch
from benchmarks import bench_io_size as jio
from benchmarks import bench_kernels as jker
from benchmarks import bench_pgm_tuning_curve as jpc
from benchmarks import bench_point_accuracy as jpa
from benchmarks import bench_range_accuracy as jra
from benchmarks import bench_rmi_tuning_curve as jrc
from repro_torch.launch import bench_covariance as tcov
from repro_torch.launch import bench_estimate_grid as teg
from repro_torch.launch import bench_fetch_strategy as tfetch
from repro_torch.launch import bench_io_size as tio
from repro_torch.launch import bench_kernels as tker
from repro_torch.launch import bench_pgm_tuning_curve as tpc
from repro_torch.launch import bench_point_accuracy as tpa
from repro_torch.launch import bench_range_accuracy as tra
from repro_torch.launch import bench_rmi_tuning_curve as trc

pytestmark = pytest.mark.filterwarnings(
    "error::DeprecationWarning:repro_torch\\..*")

SMOKE = dict(n=200_000, n_queries=20_000)
CPU = dict(torch_device="cpu")


def _run(fn, **kw):
    """(stdout, return value) of one benchmark run."""
    buf = io.StringIO()
    with redirect_stdout(buf):
        out = fn(**kw)
    return buf.getvalue(), out


def _qerr_pairs(monkeypatch, jax_mod, twin):
    """Log every (estimate, truth) pair each side hands ``q_error``."""
    jlog, tlog = [], []
    monkeypatch.setattr(jax_mod, "q_error", logged(jax_mod.q_error, jlog))
    monkeypatch.setattr(twin, "q_error", logged(twin.q_error, tlog))
    return jlog, tlog


def _pairs_match(tlog, jlog):
    assert len(tlog) == len(jlog) > 0
    got = np.array([[float(x) for x in a] for a, _ in tlog])
    want = np.array([[float(x) for x in a] for a, _ in jlog])
    np.testing.assert_array_equal(got[:, 1], want[:, 1])     # replay truth
    # estimates: rtol 1e-5, or the 2e-6 hit-rate bound carried through
    # (1 - h) E[DAC] where h sits within float32 ulps of 1 (E[DAC] >= 1)
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=1e-5, atol=2e-6)


@pytest.mark.parametrize("jax_mod,twin", [(jpa, tpa), (jra, tra)],
                         ids=["point_tableIV", "range_tableV"])
def test_accuracy_tables_match_jax(monkeypatch, jax_mod, twin):
    kw = dict(datasets=("books",), workloads=("w4",), **SMOKE)
    jlog, tlog = _qerr_pairs(monkeypatch, jax_mod, twin)
    jout, _ = _run(jax_mod.run, **kw)
    tout, rec = _run(twin.run, **kw, **CPU)
    _pairs_match(tlog, jlog)
    jrows, trows = csv_rows(jout), csv_rows(tout)
    assert list(trows) == list(jrows) == list(rec["rows"])
    for name in rec["rows"]:
        if "/Replay-" in name or name.endswith("/LPM"):
            assert fields(trows[name])["mean_qerr"] \
                == fields(jrows[name])["mean_qerr"], name


@pytest.mark.parametrize("jax_mod,twin,knobs", [
    (jpc, tpc, ("eps_star_cam", "eps_star_actual", "ushaped")),
    (jrc, trc, ("branch_star_cam", "branch_star_actual"))],
    ids=["pgm_fig7", "rmi_fig8"])
def test_tuning_curves_match_jax(monkeypatch, jax_mod, twin, knobs):
    jlog, tlog = _qerr_pairs(monkeypatch, jax_mod, twin)
    jout, _ = _run(jax_mod.run, **SMOKE)
    tout, rec = _run(twin.run, **SMOKE, **CPU)
    _pairs_match(tlog, jlog)
    jrows, trows = csv_rows(jout), csv_rows(tout)
    assert list(trows) == list(jrows) == list(rec["curves"])
    for name, derived in jrows.items():
        want, got = fields(derived), fields(trows[name])
        assert {k: got[k] for k in knobs} == {k: want[k] for k in knobs}, \
            name
        assert {k: str(rec["curves"][name][k]) for k in knobs} \
            == {k: want[k] for k in knobs}


def test_estimate_grid_matches_jax(monkeypatch, tmp_path):
    share_fit(monkeypatch)
    with redirect_stdout(io.StringIO()):
        want = jeg.run(**SMOKE, out_path=str(tmp_path / "jax.json"))
    _, got = _run(teg.run, **SMOKE, **CPU)
    assert got["max_rel_io_diff_vs_legacy"] <= 1e-5
    assert want["max_rel_io_diff_vs_legacy"] <= 1e-5
    drop = {"max_rel_io_diff_vs_legacy"}
    assert_same({k: v for k, v in got.items() if k not in drop},
                {k: v for k, v in want.items() if k not in drop}, rtol=1e-5)


@pytest.mark.parametrize("jax_mod,twin", [(jio, tio), (jcov, tcov),
                                          (jfetch, tfetch)],
                         ids=["io_size_tableI", "covariance_tableII",
                              "fetch_strategy_fig5"])
def test_host_tables_print_the_jax_lines(jax_mod, twin):
    jout, _ = _run(jax_mod.run, **SMOKE)
    tout, rec = _run(twin.run, **SMOKE, **CPU)
    assert csv_rows(tout) == csv_rows(jout)
    assert list(rec["rows"]) == list(csv_rows(jout))


def test_kernels_benchmark_matches_jax(monkeypatch):
    solved = []
    monkeypatch.setattr(jker.ops, "che_solve",
                        logged(jker.ops.che_solve, solved))
    jout, _ = _run(jker.run, n_pages=50_000)
    tout, rec = _run(tker.run, n_pages=50_000, **CPU)
    want = fields(csv_rows(jout)["kernels/che_solver"])
    got = fields(csv_rows(tout)["kernels/che_solver"])
    assert got["hbm_passes"] == want["hbm_passes"]
    assert rec["hbm_passes"] == 16 and rec["hbm_passes_scalar"] == 64
    assert rec["t_multi"] == pytest.approx(float(solved[-1][1]), rel=1e-4)
    assert rec["consistency_err"] <= 1e-4
    assert float(want["consistency_err"]) <= 1e-4
