"""The harness end to end at a hundredth of each cell's size on the CPU."""
import pytest

from _util import bench, run_cell

CELLS = [w["name"] for w in bench()["workloads"]]


def expected_metrics(name, trace):
    b = bench()
    e2e = [m["name"] for m in b["end_to_end"]
           if name in m.get("workloads", [name])]
    if not trace:
        return set(e2e)
    return {m["name"] for m in b["per_layer"]
            if name in m.get("workloads", [name]) and m["moves"] in e2e}


@pytest.mark.parametrize("cell", CELLS)
def test_untraced_line(cell):
    rc, line, err = run_cell(cell, seed=2**31 + 17, trace=0)
    assert rc == 0, err[-3000:]
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    # on the CPU there is no device trace: a metric read from it is left
    # out, never given a number from the CPU
    device = {m["name"] for m in bench()["end_to_end"]
              if m["source"] == "device_trace"}
    assert set(line["metrics"]) == expected_metrics(cell, False) - device
    for m in line["metrics"].values():
        assert m["value"] > 0
    assert line["device"]["platform"] == "cpu"
    # every compared number is printed beside its limit, last on stderr
    lines = err.strip().splitlines()
    tail = lines[-len(line["checks"]):]
    assert [t.split()[1] for t in tail] == list(line["checks"])
    # and just before them, where the run's time went
    phases = lines[-len(line["checks"]) - 1].split()
    assert phases[0] == "phases:"
    assert [p.split("=")[0] for p in phases[1:]] == ["setup_s", "window_s",
                                                     "check_s"]
    assert all(float(p.split("=")[1]) > 0 for p in phases[1:])


@pytest.mark.parametrize("cell", CELLS)
def test_traced_line(cell):
    rc, line, err = run_cell(cell, seed=5, trace=1, seconds=8.0)
    assert rc == 0, err[-3000:]
    assert line["correct"] is True, line["checks"]
    # on the CPU there is no device trace: only the span metrics read
    spans = {n for n in expected_metrics(cell, True)
             if "roofline" not in n and "idle" not in n}
    assert spans <= set(line["metrics"]), (line["attempted"], line["device"], err[-1500:])
    assert "busy_s" in line["device"] and "window_s" in line["device"]
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


def test_same_seed_same_inputs():
    from _util import rehearse_context
    from cambench.drivers.tune import Inputs
    import numpy as np

    a = Inputs(rehearse_context("pgm.tune-w4", 2**33 + 1))
    b = Inputs(rehearse_context("pgm.tune-w4", 2**33 + 1))
    c = Inputs(rehearse_context("pgm.tune-w4", 2**33 + 2))
    assert np.array_equal(a.keys, b.keys)
    assert all(np.array_equal(x[0], y[0]) for x, y in zip(a.pool, b.pool))
    assert a.checked == b.checked
    assert not np.array_equal(a.keys, c.keys)


def test_unknown_workload_exits_nonzero():
    rc, line, _ = run_cell("no.such-cell", seed=1, trace=0)
    assert rc != 0 and line is None


@pytest.mark.parametrize("trace", [0, 1])
def test_device_e2e_trace_covers_whole_cycles(trace):
    """An untraced run traces cycles 2 to 1 + E2E_CYCLES of its traffic for
    the end-to-end device metric; a traced run leaves that to its own
    trace.  On the CPU the device metric reads nothing."""
    import time
    import types

    import torch

    from cambench.drivers.common import E2E_CYCLES, Window

    ctx = types.SimpleNamespace(
        args=types.SimpleNamespace(trace=trace, seconds=0.5),
        device="cpu", device_e2e=True)
    win = Window(ctx, torch, ("step",), cycle=3)
    win.run(lambda i: time.sleep(0.001))
    assert len(win.latencies) > 3 * (1 + E2E_CYCLES)
    assert win.seconds >= 0.5
    readings = win.e2e_readings({"event": 7 * len(win.e2e_steps)})
    if trace:
        assert not win.e2e_steps and readings is None
    else:
        assert win.e2e_steps == range(3, 3 * (1 + E2E_CYCLES))
        assert readings.busy_ms_per("event", 1000.0) is None
