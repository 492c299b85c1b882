"""The port's twins of the online examples (``serve_adaptive``,
``shard_fleet``, ``update_heavy``) and of ``benchmarks/bench_kv_planner.py``
against the JAX package's scripts, on the CPU.

Both sides run at the ``--smoke`` size (``bench_kv_planner`` has one); the
port with ``torch_device="cpu"`` (``price_grid``'s plain version).  Bounds
(ROADMAP): every printed line equal, its wall times masked — decisions,
knobs, boundaries, merges and engine calls exact, estimates to the digits
printed; the KV planner's structural hit rates exact, its IRM (Che) hit
rates within rtol 1e-5 and its replayed ones to the digits printed.  Each
twin's gates hold.
"""
import io
import json
import runpy
import sys
from contextlib import redirect_stdout

import pytest

from _torch_paper import logged, mask_times
from repro.core import cache_models as jcm
from repro_torch.core import cache_models as tcm
from repro_torch.launch import bench_kv_planner as tkv
from repro_torch.launch import serve_adaptive as tsa
from repro_torch.launch import shard_fleet as tsf
from repro_torch.launch import update_heavy as tuh

pytestmark = pytest.mark.filterwarnings(
    "error::DeprecationWarning:repro_torch\\..*")


def _main(module, argv):
    """A twin's CLI: (printed lines before the record, the record)."""
    buf = io.StringIO()
    with redirect_stdout(buf):
        module.main(argv)
    lines = buf.getvalue().splitlines()
    return lines[:-1], json.loads(lines[-1])


@pytest.mark.parametrize("name,twin", [("serve_adaptive", tsa),
                                       ("shard_fleet", tsf),
                                       ("update_heavy", tuh)])
def test_online_example_twins_print_the_jax_examples_lines(monkeypatch,
                                                           name, twin):
    monkeypatch.setattr(sys, "argv", [f"{name}.py", "--smoke"])
    buf = io.StringIO()
    with redirect_stdout(buf):
        runpy.run_path(f"examples/{name}.py", run_name="__main__")
    lines, record = _main(twin, ["--smoke", "--device", "cpu"])
    assert mask_times("\n".join(lines)) == mask_times(buf.getvalue())
    assert record["torch_device"] == "cpu"
    if name == "serve_adaptive":
        assert record["retune_evaluations"] > 0
        assert record["retune_evaluations"] == len(record["decisions"])
    elif name == "shard_fleet":
        assert record["hotspot"]["switched"] is True
        assert record["flash"]["switched"] is False
    else:
        assert set(record["schedulers"]) == {"cam", "every_k", "on_full"}
        for rep in record["schedulers"].values():
            assert rep["engine_calls"] == rep["decision_events"] > 0


@pytest.mark.parametrize("twin,gate", [
    (tsa, "retune"), (tsf, "sustained hotspot"), (tuh, "engine calls")])
def test_online_example_gates_raise(monkeypatch, twin, gate):
    """The examples' ``assert``s are ``RuntimeError``s in the twins, so
    ``python -O`` keeps them: each fires when its condition fails."""
    if twin is tsa:
        from repro_torch.serving.session import ServingSession
        monkeypatch.setattr(ServingSession, "observe",
                            lambda self, stream: iter(()))
    elif twin is tsf:
        from repro_torch.sharding.session import ShardingSession
        real = ShardingSession.rebalance

        def rebalance(self, *a, **kw):
            import dataclasses
            return dataclasses.replace(real(self, *a, **kw), switched=False)

        monkeypatch.setattr(ShardingSession, "rebalance", rebalance)
    else:
        from repro_torch.write.session import WriteSession
        real = WriteSession.run

        def run(self, events):
            import dataclasses
            rep = real(self, events)
            return dataclasses.replace(rep, engine_calls=rep.engine_calls + 1)

        monkeypatch.setattr(WriteSession, "run", run)
    with redirect_stdout(io.StringIO()), \
            pytest.raises(RuntimeError, match=gate):
        twin.run(smoke=True, torch_device="cpu")


def test_kv_planner_matches_jax(monkeypatch):
    from benchmarks import bench_kv_planner as jkv
    jlog, tlog, jstruct, tstruct = [], [], [], []
    monkeypatch.setattr(jcm, "hit_rate", logged(jcm.hit_rate, jlog))
    monkeypatch.setattr(tcm, "hit_rate", logged(tcm.hit_rate, tlog))
    monkeypatch.setattr(jkv, "structural_hit_rate",
                        logged(jkv.structural_hit_rate, jstruct))
    monkeypatch.setattr(tkv, "structural_hit_rate",
                        logged(tkv.structural_hit_rate, tstruct))
    buf = io.StringIO()
    with redirect_stdout(buf):
        jkv.run()
    lines, record = _main(tkv, ["--device", "cpu"])
    assert lines == buf.getvalue().splitlines()
    assert [ln.split(",")[0] for ln in lines] == [
        f"kv_planner/pool{f}N" for f in ("0.2", "0.4", "0.6", "0.9", "1.2")]
    assert len(tlog) == len(jlog) == 5
    # (block tokens, pool blocks) and the hit rate, exact
    assert [(a[1:], h) for a, h in tstruct] == \
        [(a[1:], h) for a, h in jstruct]
    assert len(tstruct) == 4
    for (_, got), (_, want) in zip(tlog, jlog):
        assert float(got) == pytest.approx(float(want), rel=1e-5, abs=0.0)
    for (_, got), row in zip(tlog, record["rows"].values()):
        assert row["irm_che"] == float(got)
        assert 0.0 <= row["struct_err"] <= 1.0 and 0.0 <= row["irm_err"] <= 1
    assert record["torch_device"] == "cpu"
