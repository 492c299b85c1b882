"""Cost-model calibration for the hybrid join (paper §VI-B, §VII-D).

Fits the Eq. 17 parameters from short calibration runs against the simulated
machine, following the paper's procedure:

1. lambda_point / lambda_range = median ratio of observed I/O time to physical
   I/O count across calibration probes;
2. subtract the fitted I/O component from end-to-end time, then fit the CPU
   coefficients (alpha, delta) and (beta, eta) by ordinary least squares.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from repro_torch.index.disk_layout import PageLayout
from repro_torch.join.hybrid import JoinCostParams
from repro_torch.sim.machine import BufferedDisk, MachineParams
from repro_torch.tuning.fit import ols

__all__ = ["calibrate", "calibrate_system"]


def _point_runs(index, layout, capacity, policy, machine, rng, inner_n, n_runs=24):
    """Execute small point-probe batches; observe (N, misses, io_t, total_t)."""
    rows = []
    for _ in range(n_runs):
        n_keys = int(rng.integers(64, 1024))
        start = int(rng.integers(0, inner_n - 2 * n_keys - 1))
        pos = np.sort(rng.integers(start, start + 64 * n_keys, size=n_keys)) % inner_n
        disk = BufferedDisk(layout.num_pages(inner_n), capacity, policy)
        misses = 0
        for p in np.sort(pos):
            w = max(0, p - 8), min(inner_n - 1, p + 8)
            misses += disk.fetch_window(w[0] // layout.c_ipp, w[1] // layout.c_ipp)
        io_t = misses * machine.miss_latency_point
        total = n_keys * (machine.cpu_per_key + machine.point_op_setup) + io_t
        rows.append((n_keys, misses, io_t, total))
    return np.asarray(rows, np.float64)


def _range_runs(index, layout, capacity, policy, machine, rng, inner_n, n_runs=24):
    rows = []
    num_pages = layout.num_pages(inner_n)
    for _ in range(n_runs):
        span = int(rng.integers(8, 4096))
        start = int(rng.integers(0, max(1, num_pages - span - 1)))
        disk = BufferedDisk(num_pages, capacity, policy)
        misses = disk.fetch_window(start, start + span - 1)
        io_t = misses * machine.miss_latency_range
        total = machine.range_op_setup + span * machine.cpu_per_page_scan + io_t
        rows.append((span, misses, io_t, total))
    return np.asarray(rows, np.float64)


def calibrate_system(
    index,
    inner_keys: np.ndarray,
    system,
    machine: MachineParams = MachineParams(),
    seed: int = 0,
) -> JoinCostParams:
    """CostSession-era entry point: derive layout, capacity and policy from a
    :class:`repro_torch.core.session.System` instead of four loose arguments.

    ``index`` may be a raw index or an IndexModel adapter — anything with
    ``size_bytes`` charges its footprint against the memory budget.  This is
    the primary entry point (``JoinSession.calibrate`` routes through it);
    the loose-argument ``calibrate`` below remains for legacy callers.
    """
    index_bytes = float(getattr(index, "size_bytes", 0.0))
    capacity = max(1, system.capacity_for(index_bytes))
    return calibrate(index, inner_keys, system.layout(), capacity,
                     policy=system.policy, machine=machine, seed=seed)


def calibrate(
    index,
    inner_keys: np.ndarray,
    layout: PageLayout,
    capacity: int,
    policy: str = "lru",
    machine: MachineParams = MachineParams(),
    seed: int = 0,
) -> JoinCostParams:
    rng = np.random.default_rng(seed)
    n = len(inner_keys)

    pt = _point_runs(index, layout, capacity, policy, machine, rng, n)
    rg = _range_runs(index, layout, capacity, policy, machine, rng, n)

    # Step 1: per-miss latencies = median(io_time / misses).
    lam_p = float(np.median(pt[:, 2] / np.maximum(pt[:, 1], 1)))
    lam_r = float(np.median(rg[:, 2] / np.maximum(rg[:, 1], 1)))

    # Step 2: subtract I/O, OLS the CPU terms.
    cpu_p = pt[:, 3] - lam_p * pt[:, 1]
    coef_p = ols(np.stack([pt[:, 0], np.ones(len(pt))], axis=1), cpu_p)
    cpu_r = rg[:, 3] - lam_r * rg[:, 1]
    coef_r = ols(np.stack([rg[:, 0], np.ones(len(rg))], axis=1), cpu_r)

    return JoinCostParams(
        alpha=max(float(coef_p[0]), 1e-9),
        delta=max(float(coef_p[1]), 0.0),
        beta=max(float(coef_r[0]), 1e-9),
        eta=max(float(coef_r[1]), 0.0),
        lambda_point=max(lam_p, 1e-9),
        lambda_range=max(lam_r, 1e-9),
    )
