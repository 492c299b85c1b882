"""DEPRECATED shims: CAM-based RMI tuning (paper §V-C) + CDFShop baseline.

Every entry point delegates to
:class:`repro_torch.tuning.session.TuningSession` with an
:class:`~repro_torch.tuning.session.RMIBuilder`, and takes the JAX package's
arguments plus ``torch_device`` (the card unless the caller asks for the
CPU).  Two behavioral upgrades ride along (selection unchanged on golden
seeds):

* RMI's size model is EXACT and analytic (``rmi.rmi_size_bytes``), so
  budget-infeasible branch factors are skipped *before construction* — the
  legacy path built every candidate eagerly and let ``estimate_grid`` drop
  the infeasible ones afterwards;
* feasible branch grids profile through the batched mixed-eps kernel
  (one grouped pass for the whole grid) instead of per-branch mixture
  histograms.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import cam
from repro_torch.core.session import DEFAULT_TORCH_DEVICE, CostSession, System
from repro_torch.core.workload import Workload
from repro_torch.index import rmi
from repro_torch.index.adapters import RMIAdapter

__all__ = ["RMITuneResult", "default_branch_grid", "cam_tune_rmi",
           "estimate_rmi_io", "cdfshop_tune_rmi"]


def _deprecated(name: str) -> None:
    warnings.warn(
        f"repro_torch.tuning.rmi_tuner.{name} is deprecated; use "
        "repro_torch.tuning.session.TuningSession with an RMIBuilder",
        DeprecationWarning, stacklevel=3)


@dataclasses.dataclass
class RMITuneResult:
    best_branch: int
    est_io: float
    estimates: Dict[int, cam.CamEstimate]
    indexes: Dict[int, rmi.RMIIndex]
    tuning_seconds: float


def default_branch_grid(lo: int = 2**6, hi: int = 2**16) -> Tuple[int, ...]:
    """Doubling branch grid (delegates to the one implementation behind the
    adapters' knob metadata, ``repro_torch.index.adapters.pow2_grid``)."""
    from repro_torch.index.adapters import pow2_grid

    return pow2_grid(lo, hi)


def estimate_rmi_io(
    index: rmi.RMIIndex,
    positions: np.ndarray,
    query_keys: np.ndarray,
    geom: cam.CamGeometry,
    memory_budget: float,
    policy: str = "lru",
    sample_rate: float = 1.0,
    torch_device: str = DEFAULT_TORCH_DEVICE,
) -> cam.CamEstimate:
    """CAM estimate for a built RMI (deprecated shim over CostSession)."""
    warnings.warn(
        "estimate_rmi_io is deprecated; use "
        "repro_torch.core.session.CostSession.estimate with an RMIAdapter "
        "and a point Workload carrying query_keys",
        DeprecationWarning, stacklevel=2)
    session = CostSession(System(geom, memory_budget, policy,
                                 torch_device=torch_device))
    wl = Workload.point(positions, n=index.n, query_keys=query_keys)
    return session.estimate(RMIAdapter(index), wl, sample_rate=sample_rate)


def cam_tune_rmi(
    keys: np.ndarray,
    positions: np.ndarray,
    query_keys: np.ndarray,
    memory_budget: float,
    geom: cam.CamGeometry,
    policy: str = "lru",
    branch_grid: Optional[Sequence[int]] = None,
    sample_rate: float = 1.0,
    torch_device: str = DEFAULT_TORCH_DEVICE,
) -> RMITuneResult:
    """Branch-factor tuning (deprecated shim over ``TuningSession.tune``).

    ``RMITuneResult.indexes`` now contains only the candidates that were
    actually constructed — i.e. the budget-FEASIBLE branches; the legacy
    path built the infeasible ones too, for nothing.
    """
    _deprecated("cam_tune_rmi")
    from repro_torch.tuning.session import RMIBuilder, TuningSession

    t0 = time.perf_counter()
    builder = RMIBuilder(keys)
    grid = tuple(int(b) for b in branch_grid) if branch_grid is not None \
        else default_branch_grid()
    res = TuningSession(System(geom, memory_budget, policy,
                               torch_device=torch_device)).tune(
        builder, Workload.point(positions, n=len(keys),
                                query_keys=query_keys),
        overrides={"branch": grid}, sample_rate=sample_rate)
    indexes = {b: adapter.index for b, adapter in builder.built.items()}
    return RMITuneResult(int(res.best_knob), res.est_io, res.estimates,
                         indexes, time.perf_counter() - t0)


def cdfshop_tune_rmi(
    keys: np.ndarray,
    index_space_budget: float,
    branch_grid: Optional[Sequence[int]] = None,
    profile_lookups: int = 20_000,
    torch_device: str = DEFAULT_TORCH_DEVICE,
) -> Tuple[int, float, Dict[int, rmi.RMIIndex]]:
    """CDFShop-style baseline (deprecated shim over
    ``TuningSession.tune(tuner=CDFShopTuner(...))``).

    Returns (branch, tuning_seconds, built_indexes).  The legacy tool built
    every candidate before checking its size; the size-model path skips the
    infeasible builds with the selection unchanged.
    """
    _deprecated("cdfshop_tune_rmi")
    from repro_torch.tuning.session import (CDFShopTuner, RMIBuilder,
                                            TuningSession)

    t0 = time.perf_counter()
    builder = RMIBuilder(keys)
    grid = tuple(int(b) for b in branch_grid) if branch_grid is not None \
        else default_branch_grid()
    session = TuningSession(System(cam.CamGeometry(),
                                   2.0 * index_space_budget, "lru",
                                   torch_device=torch_device))
    res = session.tune(
        builder, Workload.point(np.zeros(1, np.int64), n=len(keys)),
        tuner=CDFShopTuner(profile_lookups=profile_lookups),
        overrides={"branch": grid})
    built = {b: adapter.index for b, adapter in builder.built.items()}
    return int(res.best_knob), time.perf_counter() - t0, built
