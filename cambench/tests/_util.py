"""Helpers of the benchmark's own tests."""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def bench():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def bench_with_parked():
    """``BENCHMARK.json`` with the parked cells of ``parked.json`` added:
    the harness still runs them, the benchmark does not."""
    b = bench()
    with open(Path(__file__).with_name("parked.json")) as f:
        parked = json.load(f)
    b["configs"] += parked["configs"]
    b["workloads"] += parked["workloads"]
    return b


def run_cell(workload: str, seed: int, trace: int, root: Path = ROOT,
             seconds: float = 3.0, extra=()):
    """Run ``python3 -m cambench.run --rehearse`` in ``root``; returns
    (exit code, last stdout line as JSON or None, stderr)."""
    env = dict(os.environ, PYTHONPATH="", OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-m", "cambench.run", "--workload", workload,
         "--seed", str(seed), "--seconds", str(seconds), "--trace",
         str(trace), "--rehearse", *extra],
        cwd=root, env=env, capture_output=True, text=True, timeout=600)
    lines = proc.stdout.strip().splitlines()
    line = None
    if lines:
        try:
            line = json.loads(lines[-1])
        except json.JSONDecodeError:
            line = None
    return proc.returncode, line, proc.stderr


def rehearse_context(workload: str, seed: int, trace: int = 0,
                     seconds: float = 2.0):
    import argparse

    from cambench.run import Context
    args = argparse.Namespace(workload=workload, seed=seed, seconds=seconds,
                              trace=trace, rehearse=True)
    return Context(args, bench_with_parked())
