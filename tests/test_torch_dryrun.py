"""The port's dry run (``python -m repro_torch.launch.dryrun``), as
``tests/test_dryrun.py`` drives the JAX one: a real subprocess (its own
fake process group of 256 ranks on the H100 production mesh, one step
under ``FakeTensorMode``), one representative cell per kind, and the skip
rule.  The two cells run side by side."""
import json
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
CELLS = [("starcoder2-3b", "decode_32k"),     # serve cell
         ("qwen2-moe-a2.7b", "train_4k")]     # MoE train cell (EP + mb + remat)


def _start(args, out):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", *args,
           "--out", str(out)]
    return subprocess.Popen(cmd, env=env, cwd=str(ROOT), text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)


def _rows(proc, out, timeout=560):
    try:
        _, err = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, err[-2000:]
    return [json.loads(line) for line in open(out)]


@pytest.fixture(scope="module")
def cell_rows(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun")
    procs = {c: _start(["--arch", c[0], "--shape", c[1]],
                       tmp / f"{c[0]}.jsonl") for c in CELLS}
    return {c: _rows(p, tmp / f"{c[0]}.jsonl") for c, p in procs.items()}


@pytest.mark.parametrize("arch,shape", CELLS)
def test_dryrun_cell_traces_on_production_mesh(arch, shape, cell_rows):
    rec = cell_rows[(arch, shape)][-1]
    assert rec["status"] == "ok", rec
    assert rec["mesh"] == "32x8"
    mem = rec["memory"]
    assert mem["resident_plus_temp"] > 0
    assert mem["peak_bytes"] >= mem["argument_bytes"] > 0
    assert isinstance(mem["fits_80g"], bool)
    assert rec["collectives"]["n_ops"] > 0
    assert rec["collectives"]["total"] == sum(
        rec["collectives"][k] for k in ("all-gather", "all-reduce",
                                        "reduce-scatter", "all-to-all",
                                        "collective-permute"))


def test_dryrun_skip_rule(tmp_path):
    out = tmp_path / "skip.jsonl"
    rows = _rows(_start(["--arch", "yi-34b", "--shape", "long_500k"], out),
                 out)
    assert rows[-1]["status"] == "skipped"
    assert "sub-quadratic" in rows[-1]["reason"]


def test_dryrun_import_sets_up_nothing():
    """Importing the module starts no process group and sets no
    environment variable (the package test imports every module)."""
    code = ("import os, torch.distributed as d; before = dict(os.environ); "
            "import repro_torch.launch.dryrun; "
            "assert not d.is_initialized(); assert dict(os.environ) == before")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=str(ROOT),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
