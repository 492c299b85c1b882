"""The port's twins of the join scripts against the JAX package's, on the
CPU: Fig 11 (``bench_join``) and the two join examples (``hybrid_join``,
``join_tree``).

Both sides run at the ``--smoke`` size; the port with
``torch_device="cpu"`` (``price_grid``'s plain version).  The JAX
benchmark's result files go to ``tmp_path``.  Bounds (ROADMAP): every
replayed execution's I/O, logical references, matches and segments exact
and its simulated seconds within rtol 1e-12, in the order both scripts
make them; decisions, splits and strategies exact; every printed line
equal with its wall times masked (the CSV lines' timing column and the
partition's speedup dropped).
"""
import io
import json
import runpy
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest

from _torch_paper import assert_same, csv_rows, fields, logged, mask_times
from benchmarks import bench_join as jbj
from repro.join import session as jsess
from repro_torch.launch import bench_join as tbj
from repro_torch.launch import hybrid_join as thj
from repro_torch.launch import join_tree as tjt
from repro_torch.join import session as tsess

pytestmark = pytest.mark.filterwarnings(
    "error::DeprecationWarning:repro_torch\\..*")


def _main(module, argv):
    """A twin's CLI: (printed lines before the record, the record)."""
    buf = io.StringIO()
    with redirect_stdout(buf):
        module.main(argv)
    lines = buf.getvalue().splitlines()
    return lines[:-1], json.loads(lines[-1])


@pytest.fixture
def executions(monkeypatch):
    """Every ``JoinSession.execute`` of both packages, logged in order."""
    jlog, tlog = [], []
    monkeypatch.setattr(jsess.JoinSession, "execute",
                        logged(jsess.JoinSession.execute, jlog))
    monkeypatch.setattr(tsess.JoinSession, "execute",
                        logged(tsess.JoinSession.execute, tlog))
    return jlog, tlog


def _assert_same_executions(tlog, jlog):
    assert len(tlog) == len(jlog) > 0
    for i, ((_, got), (_, want)) in enumerate(zip(tlog, jlog)):
        assert (got.strategy, got.physical_ios, got.logical_refs,
                got.matches, got.n_segments, got.n_range_segments) == \
            (want.strategy, want.physical_ios, want.logical_refs,
             want.matches, want.n_segments, want.n_range_segments), i
        np.testing.assert_allclose(got.seconds, want.seconds, rtol=1e-12,
                                   err_msg=str(i))


def test_bench_join_matches_jax(monkeypatch, tmp_path, executions):
    jlog, tlog = executions
    monkeypatch.setattr(jbj, "RESULTS", tmp_path)
    buf = io.StringIO()
    with redirect_stdout(buf):
        jbj.run(n=200_000, n_outer=5_000)
    lines, got = _main(tbj, ["--smoke", "--device", "cpu"])
    _assert_same_executions(tlog, jlog)

    want_rows, got_rows = csv_rows(buf.getvalue()), csv_rows("\n".join(lines))
    names = ([f"fig11/w{i}" for i in range(1, 7)]
             + [f"mix/sorted{f}" for f in ("00", "50", "90")]
             + ["partition/vectorized_vs_loop", "tree/split_vs_even"])
    assert list(got_rows) == list(want_rows) == names
    for name in names:
        g, w = fields(got_rows[name]), fields(want_rows[name])
        if name.startswith("partition/"):
            g.pop("speedup"), w.pop("speedup")
        assert g == w, name

    # the reference's two result files against the twin's record
    part = json.loads((tmp_path / "join_partition.json").read_text())
    tree = json.loads((tmp_path / "join_tree.json").read_text())
    assert got["partition"]["identical"] is True
    assert_same({k: v for k, v in got["partition"].items() if k != "speedup"},
                {k: v for k, v in part.items() if k != "speedup"}, rtol=0.0)
    assert_same(got["tree"], tree, rtol=0.0)
    assert (got["n"], got["n_outer"], got["buffer_mb"]) == (200_000, 5_000, 2)
    for wl, row in got["fig11"].items():
        assert row["paper_hybrid_speedup"] == 8.8
        want = fields(want_rows[f"fig11/{wl}"])["hybrid_speedup_vs_inlj"]
        assert f"{row['hybrid_speedup_vs_inlj']:.2f}x" == want


def test_bench_join_partition_gate_raises(monkeypatch):
    """The reference records ``identical``; the twin raises on False."""
    monkeypatch.setattr(tbj, "partition_probes_loop",
                        lambda *a, **kw: [])
    monkeypatch.setattr(tbj, "_fig11", lambda *a: {})
    monkeypatch.setattr(tbj, "_mix", lambda *a: {})
    with redirect_stdout(io.StringIO()), \
            pytest.raises(RuntimeError, match="different segments"):
        tbj.run(n=200_000, n_outer=5_000, torch_device="cpu")


@pytest.mark.parametrize("name,twin", [("hybrid_join", thj),
                                       ("join_tree", tjt)])
def test_join_example_twins_print_the_jax_examples_lines(
        monkeypatch, executions, name, twin):
    jlog, tlog = executions
    monkeypatch.setattr(sys, "argv", [f"{name}.py", "--smoke"])
    buf = io.StringIO()
    with redirect_stdout(buf):
        runpy.run_path(f"examples/{name}.py", run_name="__main__")
    lines, record = _main(twin, ["--smoke", "--device", "cpu"])
    assert mask_times("\n".join(lines)) == mask_times(buf.getvalue())
    _assert_same_executions(tlog, jlog)
    assert record["torch_device"] == "cpu"
    if name == "hybrid_join":
        assert (record["n"], record["n_outer"]) == (200_000, 20_000)
        assert set(record["workloads"]) == {"w1", "w3", "w4"}
    else:
        assert record["pool_pages"] == 512
        assert list(record["workloads"]) == ["w1"]
