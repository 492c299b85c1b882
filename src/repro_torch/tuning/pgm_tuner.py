"""DEPRECATED shims: CAM-based PGM tuning (paper §V-B).

Every entry point here now delegates to the ONE tuning surface,
:class:`repro_torch.tuning.session.TuningSession` — declarative knob spaces,
lazy size models, pluggable tuner strategies, and the joint (knob x
buffer-split) search.  The shims are kept for golden equivalence: the JAX
package's signatures plus ``torch_device`` wherever a :class:`System` is
made (the card unless the caller asks for the CPU), the same result
shapes, the same chosen knobs on fixed seeds.  New code should build a
:class:`~repro_torch.tuning.session.PGMBuilder` and call
``TuningSession.tune``.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import cam
from repro_torch.core.session import (DEFAULT_TORCH_DEVICE, CostSession,
                                      GridCandidate, System)
from repro_torch.core.workload import Workload
from repro_torch.tuning import fit

__all__ = ["PGMTuneResult", "default_eps_grid", "profile_pgm_size_model",
           "cam_tune_pgm", "cam_tune_uniform_eps", "multicriteria_pgm_tune"]


def _deprecated(name: str) -> None:
    warnings.warn(
        f"repro_torch.tuning.pgm_tuner.{name} is deprecated; use "
        "repro_torch.tuning.session.TuningSession with a PGMBuilder",
        DeprecationWarning, stacklevel=3)


@dataclasses.dataclass
class PGMTuneResult:
    best_eps: int
    est_io: float
    estimates: Dict[int, cam.CamEstimate]
    size_model: fit.PowerLawFit
    tuning_seconds: float


def default_eps_grid(lo: int = 4, hi: int = 4096) -> Tuple[int, ...]:
    """Dense sqrt(2)-spaced grid — much denser than what replay could afford.

    Delegates to the one implementation behind the adapters' knob metadata
    (``repro_torch.index.adapters.sqrt2_grid``)."""
    from repro_torch.index.adapters import sqrt2_grid

    return sqrt2_grid(lo, hi)


def profile_pgm_size_model(
    keys: np.ndarray, sample_eps: Sequence[int] = (16, 64, 256, 1024)
) -> Tuple[fit.PowerLawFit, float]:
    """Build a few PGMs, fit M_idx(eps) = a*eps^-b + c (deprecated shim over
    the lazy :class:`repro_torch.tuning.session.PowerLawSizeModel`)."""
    _deprecated("profile_pgm_size_model")
    from repro_torch.tuning.session import PGMBuilder

    model = PGMBuilder(keys, tuple(sample_eps)).size_model()
    fitted = model.fitted
    return fitted, model.fit_seconds


def cam_tune_uniform_eps(
    workload: Workload,
    size_model: fit.PowerLawFit,
    system: System,
    eps_grid: Sequence[int],
    sample_rate: float = 1.0,
) -> Tuple[int, Dict[int, cam.CamEstimate], float]:
    """Shared grid tuner for any uniformly error-bounded family (deprecated
    shim; ``CostSession.estimate_grid`` semantics preserved exactly).

    Returns (best_eps, estimates, grid_seconds).
    """
    _deprecated("cam_tune_uniform_eps")
    session = CostSession(system)
    cands = [
        GridCandidate(knob=int(e), eps=int(e), size_bytes=float(size_model(e)))
        for e in eps_grid
    ]
    res = session.estimate_grid(cands, workload, sample_rate=sample_rate)
    return int(res.best_knob), dict(res.estimates), res.seconds


def cam_tune_pgm(
    keys: np.ndarray,
    positions: np.ndarray,
    memory_budget: float,
    geom: cam.CamGeometry,
    policy: str = "lru",
    eps_grid: Optional[Sequence[int]] = None,
    sample_eps: Sequence[int] = (16, 64, 256, 1024),
    sample_rate: float = 1.0,
    torch_device: str = DEFAULT_TORCH_DEVICE,
) -> PGMTuneResult:
    """Eq. 15/16 eps tuning (deprecated shim over ``TuningSession.tune``)."""
    _deprecated("cam_tune_pgm")
    from repro_torch.tuning.session import PGMBuilder, TuningSession

    t0 = time.perf_counter()
    builder = PGMBuilder(keys, tuple(sample_eps))
    grid = tuple(int(e) for e in eps_grid) if eps_grid is not None \
        else default_eps_grid()
    res = TuningSession(System(geom, memory_budget, policy,
                               torch_device=torch_device)).tune(
        builder, Workload.point(positions, n=len(keys)),
        overrides={"eps": grid}, sample_rate=sample_rate)
    return PGMTuneResult(
        best_eps=int(res.best_knob),
        est_io=res.est_io,
        estimates=res.estimates,
        size_model=res.size_model.fitted,
        tuning_seconds=time.perf_counter() - t0,
    )


def multicriteria_pgm_tune(
    keys: np.ndarray,
    index_space_budget: float,
    eps_grid: Optional[Sequence[int]] = None,
    sample_eps: Sequence[int] = (16, 64, 256, 1024),
    profile_lookups: int = 20_000,
    torch_device: str = DEFAULT_TORCH_DEVICE,
) -> Tuple[int, float]:
    """Cache-oblivious multicriteria-PGM baseline (deprecated shim over
    ``TuningSession.tune(tuner=MulticriteriaTuner(...))``).

    Returns (eps, tuning_seconds).
    """
    _deprecated("multicriteria_pgm_tune")
    from repro_torch.tuning.session import (MulticriteriaTuner, PGMBuilder,
                                            TuningSession)

    t0 = time.perf_counter()
    builder = PGMBuilder(keys, tuple(sample_eps))
    grid = tuple(int(e) for e in eps_grid) if eps_grid is not None \
        else default_eps_grid()
    if not profile_lookups:
        # legacy profile-free mode: the most accurate candidate that fits
        model = builder.size_model()
        feasible = [e for e in grid
                    if float(model(eps=e)) <= index_space_budget]
        return min(feasible or [max(grid)]), time.perf_counter() - t0
    # The baseline reserves half the (synthetic) budget as buffer, so a
    # budget of 2x the index space reproduces the legacy index_space_budget.
    session = TuningSession(System(cam.CamGeometry(),
                                   2.0 * index_space_budget, "lru",
                                   torch_device=torch_device))
    res = session.tune(
        builder, Workload.point(np.zeros(1, np.int64), n=len(keys)),
        tuner=MulticriteriaTuner(profile_lookups=profile_lookups),
        overrides={"eps": grid})
    return int(res.best_knob), time.perf_counter() - t0
