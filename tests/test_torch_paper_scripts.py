"""The port's twins of the paper's main-path experiment scripts against
the JAX package's scripts, on the CPU: Figs 9/10 (``bench_tuning_e2e``),
the two examples (``quickstart``, ``tune_pgm``), the two device-executor
benchmarks (``bench_engine``, ``bench_profile_grid``) and the driver
(``bench_run``).

Both sides run on the same arguments, at or below the ``--smoke`` size;
the port with ``torch_device="cpu"`` (its kernels' plain versions).  The
JAX scripts' result paths go to ``tmp_path``.  Where a script fits the
power-law size model, both packages are given the same fitted curve.
Bounds: chosen knobs, splits, replayed QPS and miss counts exact (the
replay is the same numpy on the same windows); hit rates within 2e-6; the
equivalence gates equal; every printed number that is not a time equal.
No timing field is compared.
"""
import io
import json
import runpy
import sys
from contextlib import redirect_stdout

import pytest

from _torch_paper import assert_same, logged, mask_times, share_fit
from benchmarks import bench_engine as jbe
from benchmarks import bench_profile_grid as jbp
from benchmarks import bench_tuning_e2e as jbte
from repro_torch.launch import bench_engine as tbe
from repro_torch.launch import bench_profile_grid as tbp
from repro_torch.launch import bench_run
from repro_torch.launch import bench_tuning_e2e as tbte
from repro_torch.launch import quickstart as tquick
from repro_torch.launch import tune_pgm as ttune

pytestmark = pytest.mark.filterwarnings(
    "error::DeprecationWarning:repro_torch\\..*")


@pytest.fixture
def shared_fit(monkeypatch):
    share_fit(monkeypatch)


def _main(module, argv):
    """A twin's CLI: (printed lines before the record, the record)."""
    buf = io.StringIO()
    with redirect_stdout(buf):
        module.main(argv)
    lines = buf.getvalue().splitlines()
    return lines[:-1], json.loads(lines[-1])


def test_tuning_e2e_matches_jax(shared_fit, monkeypatch, tmp_path):
    kw = dict(n=200_000, n_queries=20_000, budgets_mb=(1.0,))
    jlog, tlog = [], []
    monkeypatch.setattr(jbte, "_qps", logged(jbte._qps, jlog))
    monkeypatch.setattr(tbte, "_qps", logged(tbte._qps, tlog))
    with redirect_stdout(io.StringIO()):
        want = jbte.run(**kw, out_path=str(tmp_path / "jax.json"))
    out = tmp_path / "port.json"
    buf = io.StringIO()
    with redirect_stdout(buf):
        got = tbte.run(**kw, out_path=str(out), torch_device="cpu")
    # every replayed configuration: (QPS, misses) exact, in order
    assert [r for _, r in tlog] == [r for _, r in jlog]
    assert len(tlog) == 6
    assert_same(got, want, rtol=0.0)
    entry = got["budgets"]["1.0"]
    assert set(entry) == {"pgm", "rmi", "radixspline_joint"}
    assert got["mixed_eps_kernel"]["n_candidates"] == 11
    # the record is written only where out_path is given, and is the record
    assert json.loads(out.read_text()) == json.loads(json.dumps(got))
    assert "tuning_e2e/json" in buf.getvalue()


def test_tuning_e2e_smoke_cli_takes_the_reference_smoke_sizes(monkeypatch):
    seen = {}
    monkeypatch.setattr(tbte, "run", lambda **kw: seen.update(kw) or kw)
    _, record = _main(tbte, ["--smoke", "--device", "cpu"])
    assert seen == dict(n=200_000, n_queries=20_000, budgets_mb=(0.5, 1.0),
                        torch_device="cpu")
    assert record["budgets_mb"] == [0.5, 1.0]      # the record is the JSON


@pytest.mark.parametrize("name,twin", [("quickstart", tquick),
                                       ("tune_pgm", ttune)])
def test_example_twins_print_the_jax_examples_numbers(shared_fit, monkeypatch,
                                                      name, twin):
    monkeypatch.setattr(sys, "argv", [f"{name}.py", "--smoke"])
    buf = io.StringIO()
    with redirect_stdout(buf):
        runpy.run_path(f"examples/{name}.py", run_name="__main__")
    lines, record = _main(twin, ["--smoke", "--device", "cpu"])
    assert mask_times("\n".join(lines)) == mask_times(buf.getvalue())
    assert record["torch_device"] == "cpu"
    if name == "quickstart":
        assert set(record["families"]) == {"pgm", "rmi", "radixspline"}
        assert all(f["q_error"] >= 1.0 for f in record["families"].values())
    else:
        assert record["replayed"]["CAM"]["qps"] \
            >= record["replayed"]["baseline"]["qps"]


@pytest.mark.parametrize("jax_mod,twin", [(jbe, tbe), (jbp, tbp)],
                         ids=["engine", "profile_grid"])
def test_device_executor_benchmarks_match_jax(monkeypatch, tmp_path,
                                              jax_mod, twin):
    monkeypatch.setattr(jax_mod, "RESULTS", tmp_path)
    with redirect_stdout(io.StringIO()):
        want = jax_mod.run(smoke=True)
    _, got = _main(twin, ["--smoke", "--device", "cpu"])
    assert got["gates"] == want["gates"]
    assert all(v for k, v in got["gates"].items() if "warm" not in k)
    assert got["gates"]["fused_2.0x_warm"] is None     # not timed on a CPU
    diff = ("max_abs_hit_rate_diff" if twin is tbe
            else "max_norm_occupancy_diff")
    assert got[diff] <= 2e-6 and want[diff] <= 2e-6
    assert got.get("max_rel_totals_diff", 0.0) <= 2e-6
    assert_same({k: v for k, v in got.items() if "diff" not in k},
                {k: v for k, v in want.items() if "diff" not in k},
                rtol=0.0)


def _reference_names() -> set:
    """The names of ``benchmarks/run.py``'s table (a local of its
    ``main``), read from its source."""
    import ast
    import pathlib
    tree = ast.parse(pathlib.Path("benchmarks/run.py").read_text())
    (table,) = [n.value for n in ast.walk(tree) if isinstance(n, ast.Assign)
                and any(getattr(t, "id", None) == "table" for t in n.targets)]
    return {k.value for k in table.keys}


def test_driver_runs_twins_and_exits_nonzero_on_a_failure(monkeypatch,
                                                          capsys):
    assert bench_run.main(["--smoke", "--device", "cpu", "--only",
                           "io_size", "fetch_strategy"]) == 0
    out = capsys.readouterr().out
    assert out.splitlines()[0] == "name,us_per_call,derived"
    assert "tableI/PGM" in out and "fig5/eps64/threads1" in out

    def boom(**kw):
        raise RuntimeError("broken twin")

    table = bench_run.table()
    assert set(table) == _reference_names()
    monkeypatch.setattr(bench_run, "table",
                        lambda: dict(table, io_size=boom))
    assert bench_run.main(["--smoke", "--device", "cpu", "--only",
                           "io_size", "fetch_strategy"]) == 1
    out = capsys.readouterr().out
    assert "io_size,0,ERROR:RuntimeError:broken twin" in out
    assert "fig5/eps64" in out         # the driver went on
