"""Helpers of the parity tests of the paper-experiment twins
(``tests/test_torch_paper_*.py``): a shared fitted size model, records
compared without their timings, CSV lines parsed, calls logged."""
import dataclasses
import re

import pytest

from repro.tuning import fit as jfit
from repro_torch.tuning import fit as tfit

#: Record fields that are timings (or ratios of timings): never compared.
TIMING = {"tuning_seconds", "tuning_time_ratio", "speedup_warm",
          "speedup_cold", "batched", "per_branch", "seconds",
          "replay100_seconds", "estimation_seconds", "scalar_seconds",
          "multi_seconds", "device_over_host_speedup"}
#: Record fields only the port has (where it ran).
PORT_ONLY = {"torch_device", "host_device", "backend", "fused_timed"}


def share_fit(monkeypatch):
    """Route the port's power-law fits through the JAX fit, so both
    packages price the same fitted size curves (the fit itself moves by up
    to ~5e-3 on a one-ulp input change, a held divergence)."""
    def fit(xs, ys, **kw):
        return tfit.PowerLawFit(**dataclasses.asdict(
            jfit.fit_power_law(xs, ys, **kw)))

    monkeypatch.setattr(tfit, "fit_power_law", fit)


def _skipped(key) -> bool:
    return key in TIMING or str(key).endswith("_seconds") or \
        str(key).endswith("_seconds_warm")


def assert_same(got, want, rtol: float, path: str = "record"):
    """``got`` (the port's record) equals ``want`` (JAX's) field by field,
    timings skipped; floats within ``rtol`` (0: exact), everything else
    exact."""
    if isinstance(want, dict):
        keys = {k for k in want if not _skipped(k)}
        port = {k for k in got if not _skipped(k)} - (PORT_ONLY - set(want))
        assert keys == port, (path, sorted(keys ^ port))
        for k in keys:
            assert_same(got[k], want[k], rtol, f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, rtol, f"{path}[{i}]")
    elif isinstance(want, float) and not isinstance(got, bool):
        assert got == pytest.approx(want, rel=rtol, abs=0.0), path
    else:
        assert got == want, path


def csv_rows(text: str) -> dict:
    """``name,us_per_call,derived`` lines of a benchmark's output as
    ``{name: derived}`` (the timing column dropped)."""
    rows = {}
    for line in text.splitlines():
        parts = line.split(",", 2)
        if len(parts) == 3 and "/" in parts[0]:
            rows[parts[0]] = parts[2]
    return rows


def fields(derived: str) -> dict:
    """``a=1;b=2x`` as ``{"a": "1", "b": "2x"}``."""
    return dict(kv.split("=", 1) for kv in derived.split(";"))


def mask_times(text: str) -> list:
    """An example's printed lines with their wall times masked."""
    text = re.sub(r"in \d+ ms", "in # ms", text)
    text = re.sub(r"\d+\.\ds", "#s", text)
    return text.rstrip("\n").splitlines()


def logged(fn, log: list):
    """``fn`` that appends each call's (arguments, result) to ``log``."""
    def wrapper(*a, **kw):
        out = fn(*a, **kw)
        log.append((a, out))
        return out
    return wrapper
