"""``rmi.online-drift``: a rehearsal is correct, planted faults are not, the
memoised RMI reference computes what a recomputing one does, and the cell
was added from new files only."""
import hashlib
import json

import numpy as np
import pytest
import torch

from _util import ROOT, rehearse_context, run_cell
from test_cambench_reference import (_Counting, _late_hit_scale, _run_with,
                                     _stream_len)

CELL = "rmi.online-drift"


def test_rehearsal_is_correct():
    rc, line, err = run_cell(CELL, seed=2**31 + 77, trace=0, seconds=3.0)
    assert rc == 0, err[-3000:]
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0


def _hi_bound_from_lo_leaf(monkeypatch):
    from repro_torch.index.adapters import RMIAdapter

    real = RMIAdapter.range_ref_eps

    def lower_twice(self, workload, geom):
        e_lo, _ = real(self, workload, geom)
        return e_lo, e_lo

    monkeypatch.setattr(RMIAdapter, "range_ref_eps", lower_twice)


@pytest.mark.parametrize("fault", [_hi_bound_from_lo_leaf, _late_hit_scale])
def test_planted_fault_is_not_correct(fault, monkeypatch):
    late = fault is _late_hit_scale
    out = _run_with(CELL, monkeypatch, fault, seconds=4.0 if late else 1.0)
    assert out["attempted"] > (3 * _stream_len(CELL) if late else 0)
    assert out["correct"] is False, out["checks"]


@pytest.fixture(scope="module")
def rmi_replay():
    """A lower-precision run of the RMI reference over three cycles and
    more of the stream (as the control makes one)."""
    from cambench.drivers.online import Inputs
    from cambench.reference.online import run_alone
    from cambench.reference.online_rmi import RMIOnlineReference
    from cambench.reference.tune import knob_sizes

    inp = Inputs(rehearse_context(CELL, seed=2**31 + 211))
    sizes, rmis = knob_sizes(inp)
    low = RMIOnlineReference(inp, sizes, rmis, "cpu",
                             profile_dtype=torch.float32,
                             price_dtype=torch.bfloat16,
                             summary_dtype=np.float32)
    n = 3 * len(inp.stream) + 11
    program = run_alone(low, inp.warm, inp.stream, n, inp.check_evaluations)
    return inp, sizes, rmis, program


def test_memoised_reference_equals_recomputing(rmi_replay):
    from cambench.reference.online import follow
    from cambench.reference.online_rmi import RMIOnlineReference

    class Counting(_Counting, RMIOnlineReference):
        pass

    class Recomputing(Counting):
        def memo(self, store, key, make):
            return make()

    inp, sizes, rmis, program = rmi_replay
    once_ref = Counting(inp, sizes, rmis, "cpu")
    every_ref = Recomputing(inp, sizes, rmis, "cpu")
    once = follow(once_ref, inp.warm, inp.stream, program)
    every = follow(every_ref, inp.warm, inp.stream, program)
    assert once == every
    assert once["hit_err"] > 0 and once["profile_err"] > 0, once
    assert once_ref.calls["chunk"] <= len(inp.warm) + len(inp.stream)
    assert every_ref.calls["chunk"] == len(inp.warm) + len(program["batches"])


# The files of the PGM online cell that this cell is built beside, and the
# configuration it runs as it was: the cell brings its own driver,
# reference, traffic and limits, and none of these changes.
_BESIDE = {
    "cambench/configs/cam-rmi-books20m.json":
        "478d0b0301330d2561229a901059da8f1717a6db1db7a4e050d6ede736f3a8ad",
    "cambench/drivers/online.py":
        "9ba9fc65131e09e5f87ecae62c5c716bd24c6f2cc119af2c9ef49beaee411b54",
    "cambench/reference/online.py":
        "e1422e72ae538be6521edb68851dc130f56f9aee29330866e0c11d5fa30dd769",
    "cambench/traffic/online-drift.json":
        "01b0539211ae1406a17949f3a5cf3e3066611184d560a3968492cf8c999ab47e",
    "cambench/limits/pgm.online-drift.json":
        "319d9f4207a6de5d8ea1b9af47802b4eccc4dd17a25adcb3b540a792721d7201",
}


def test_files_beside_it_byte_identical():
    got = {rel: hashlib.sha256((ROOT / rel).read_bytes()).hexdigest()
           for rel in _BESIDE}
    assert got == _BESIDE


def test_traffic_is_the_pgm_drift_log_with_its_own_driver():
    traffic = ROOT / "cambench/traffic"
    rmi = json.loads((traffic / "online-drift-rmi.json").read_text())
    pgm = json.loads((traffic / "online-drift.json").read_text())
    assert rmi.pop("driver") == "online_rmi"
    assert pgm.pop("driver") == "online"
    assert rmi == pgm
