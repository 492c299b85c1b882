"""The per-layer metrics that read the program's own spans and counters
(``repro_torch.obs`` through ``cambench/program.py``)."""
import sys

import numpy as np
import pytest

from _util import bench, run_cell

CELLS = [w["name"] for w in bench()["workloads"]]


#: The metrics each cell reads from the program's own spans and counters.
PROGRAM = {
    "pgm.tune-policy-10k": {"tune_self_ms.tune", "price_host_ms.tune",
                            "sync_wait_ms.tune", "host_syncs.tune",
                            "h2d_kb.tune"},
    "pgm.online-drift": {"locate_ms.online", "locate_cast_mb.online",
                         "drift_ms.online", "host_syncs.online"},
}


def program_metrics(cell):
    return PROGRAM.get(cell, set())


def test_nine_metrics():
    declared = {m["name"]: m for m in bench()["per_layer"]}
    for cell, names in PROGRAM.items():
        for name in names:
            m = declared[name]
            assert (m["source"], m["better"], m["workloads"]) == (
                "program_span", "lower", [cell])
    assert sum(map(len, PROGRAM.values())) == 9


@pytest.mark.parametrize("cell", CELLS)
def test_traced_line_reads_the_program(cell):
    rc, line, err = run_cell(cell, seed=2**33 + 5, trace=1, seconds=6.0)
    assert rc == 0, err[-3000:]
    assert line["correct"] is True, line["checks"]
    got = line["metrics"]
    for name in program_metrics(cell):
        assert name in got, (name, err[-1500:])
        assert got[name]["value"] is not None and got[name]["value"] >= 0
    # CPU tensors: no transfer to or from a card
    for name in ("host_syncs.tune", "h2d_kb.tune", "sync_wait_ms.tune",
                 "host_syncs.online"):
        if name in got:
            assert got[name]["value"] == 0.0
    if cell == "pgm.online-drift":
        # float64 event keys into uint64 keys below 2**53: each query is
        # mapped into the key dtype, and the key file is never converted
        assert got["locate_cast_mb.online"]["value"] == 0.0
        assert got["locate_ms.online"]["value"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_untraced_line_reads_none(cell):
    rc, line, err = run_cell(cell, seed=11, trace=0, seconds=2.0)
    assert rc == 0, err[-3000:]
    assert not program_metrics(cell) & set(line["metrics"])


def test_program_without_the_module_reads_nothing(monkeypatch):
    from cambench import program

    monkeypatch.setitem(sys.modules, "repro_torch.obs", None)
    assert program.per_root("cam.tune", lambda s: 1.0) is None


def test_no_program_span_is_a_harness_label():
    from cambench.drivers import online, tune
    from repro_torch import obs
    from repro_torch.core.cam import CamGeometry
    from repro_torch.core.session import System
    from repro_torch.core.workload import Workload
    from repro_torch.tuning.session import PGMBuilder, TuningSession

    keys = np.arange(0, 2**20, 16, dtype=np.uint64)
    ts = TuningSession(System(CamGeometry(c_ipp=64, page_bytes=4096),
                              32 * 4096, "lru", torch_device="cpu"))
    obs.reset()
    obs.enable()
    try:
        ts.tune(PGMBuilder(keys), Workload.from_keys(keys, keys[::7]),
                overrides={"eps": (16, 64)})
        names = set(obs.snapshot()["spans"])
    finally:
        obs.disable()
        obs.reset()
    assert {"cam.locate", "cam.tune", "cam.profile", "cam.price"} <= names
    labels = set(tune.SPANS) | set(online.SPANS) | {"harness"}
    assert not names & labels
