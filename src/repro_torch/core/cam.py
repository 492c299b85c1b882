"""CAM — the end-to-end cache-aware I/O cost estimator (paper Alg. 1 + §III).

Composition:  Cost_CAM = (1 - h) * E[DAC]          (Eq. 3)

  1. map queries to true ranks (host-side searchsorted, reused across eps),
  2. structural page-reference histogram -> Pr_req      (§IV, torch),
  3. policy-specific hit-rate model on Pr_req           (§III-B / §III-C),
  4. expected data-access cost from the fetch lemmas    (§III-D),
  5. optionally compose with a device-side model        (§III-A).

Everything after step 1 is torch code on the session's device.

NOTE: the per-shape entry points below (``estimate_point_io`` /
``estimate_range_io`` / ``estimate_sorted_io``) are DEPRECATED shims kept for
golden equivalence; new code should use the index-agnostic
:class:`repro_torch.core.session.CostSession` with a
:class:`repro_torch.core.workload.Workload` — which also adds batched knob-grid
estimation (``estimate_grid``) these one-shot functions cannot express.
The shims take the JAX package's arguments plus ``torch_device``: the card
(``"cuda"``, the sessions' default) unless the caller asks for the CPU.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

import numpy as np

__all__ = ["CamGeometry", "CamEstimate", "estimate_point_io", "estimate_range_io",
           "estimate_sorted_io", "sample_workload", "capacity_pages"]


@dataclasses.dataclass(frozen=True)
class CamGeometry:
    """Disk layout of the data file (index-data separation design, §II-B)."""

    c_ipp: int = 256            # items per page
    page_bytes: int = 4096      # page size B
    strategy: str = "all_at_once"

    def num_pages(self, n: int) -> int:
        return -(-n // self.c_ipp)


@dataclasses.dataclass(frozen=True)
class CamEstimate:
    """CAM output + diagnostics."""

    io_per_query: float         # expected physical I/Os per query (Eq. 3)
    hit_rate: float
    dac: float                  # expected logical refs per query
    capacity_pages: int
    total_refs: float           # R
    distinct_pages: float       # N (pages with nonzero mass)
    estimation_seconds: float
    policy: str
    device_cost: Optional[float] = None   # §III-A composition, if a device set

    @property
    def miss_rate(self) -> float:
        return 1.0 - self.hit_rate


def capacity_pages(memory_budget_bytes: float, index_bytes: float, page_bytes: int) -> int:
    """C = floor((M - M_idx) / B)  — Alg. 1 line 15."""
    return int(max(0, (memory_budget_bytes - index_bytes) // page_bytes))


def _deprecated(old: str) -> None:
    warnings.warn(
        f"cam.{old} is deprecated; use repro_torch.core.session.CostSession with a "
        "repro_torch.core.workload.Workload (estimate / estimate_grid)",
        DeprecationWarning, stacklevel=3)


def sample_workload(arr: np.ndarray, rate: float, seed: int = 0) -> np.ndarray:
    """CAM-x: estimate from an x% workload sample (keeps order for sorted use).

    Deprecated shim over :meth:`repro_torch.core.workload.Workload.sample`.
    """
    arr = np.asarray(arr)
    if rate >= 1.0:
        return arr
    from repro_torch.core.workload import subsample_indices

    return arr[subsample_indices(arr.shape[0], rate, seed)]


def _session(geom: CamGeometry, memory_budget_bytes: float, policy: str,
             torch_device: str):
    from repro_torch.core.session import CostSession, System

    return CostSession(System(geom, memory_budget_bytes, policy,
                              torch_device=torch_device))


def estimate_point_io(
    positions: np.ndarray,
    eps: int,
    n: int,
    geom: CamGeometry,
    memory_budget_bytes: float,
    index_bytes: float,
    policy: str = "lru",
    sample_rate: float = 1.0,
    seed: int = 0,
    torch_device: str = "cuda",
) -> CamEstimate:
    """Algorithm 1 for point workloads (deprecated shim).

    ``positions`` are the true ranks of the query keys (LocateQueries output —
    computed once per (dataset, workload) pair and reused across every
    (eps, M) candidate, which is where CAM's tuning-loop speedup comes from).
    """
    _deprecated("estimate_point_io")
    from repro_torch.core.session import UniformEpsModel
    from repro_torch.core.workload import Workload

    return _session(geom, memory_budget_bytes, policy, torch_device).estimate(
        UniformEpsModel(int(eps), int(n), float(index_bytes)),
        Workload.point(positions, n=int(n)),
        sample_rate=sample_rate, seed=seed)


def estimate_range_io(
    lo_positions: np.ndarray,
    hi_positions: np.ndarray,
    eps: int,
    n: int,
    geom: CamGeometry,
    memory_budget_bytes: float,
    index_bytes: float,
    policy: str = "lru",
    sample_rate: float = 1.0,
    seed: int = 0,
    torch_device: str = "cuda",
) -> CamEstimate:
    """Algorithm 1 for range workloads (§IV-B) (deprecated shim)."""
    _deprecated("estimate_range_io")
    from repro_torch.core.session import UniformEpsModel
    from repro_torch.core.workload import Workload

    return _session(geom, memory_budget_bytes, policy, torch_device).estimate(
        UniformEpsModel(int(eps), int(n), float(index_bytes)),
        Workload.range_scan(lo_positions, hi_positions, n=int(n)),
        sample_rate=sample_rate, seed=seed)


def estimate_sorted_io(
    window_lo: np.ndarray,
    window_hi: np.ndarray,
    eps: int,
    n: int,
    geom: CamGeometry,
    memory_budget_bytes: float,
    index_bytes: float,
    torch_device: str = "cuda",
) -> CamEstimate:
    """Sorted probe streams (joins): Theorem III.1 closed form under LRU.

    ``window_lo/hi`` are per-query *position* windows in sorted order.
    Requires C >= 1 + ceil(2*eps/C_ipp) to be exact.  (Deprecated shim —
    pinned to LRU; for policy-aware sorted estimates (LFU's frequency
    pathology, thrash regime) use ``CostSession`` with a sorted
    ``Workload``, which dispatches through ``cache_models.sorted_scan_*``.)
    """
    _deprecated("estimate_sorted_io")
    from repro_torch.core.session import UniformEpsModel
    from repro_torch.core.workload import Workload

    return _session(geom, memory_budget_bytes, "lru", torch_device).estimate(
        UniformEpsModel(int(eps), int(n), float(index_bytes)),
        Workload.sorted_stream(window_lo, window_hi, n=int(n)))
