"""DEPRECATED shims: CAM-based RadixSpline tuning.

Delegates to :class:`repro_torch.tuning.session.TuningSession` with a
:class:`~repro_torch.tuning.session.RadixSplineBuilder`.  The legacy entry
point pinned ``radix_bits`` and tuned the corridor eps alone; the session
tunes the full 2-D (eps x radix_bits) plane — ``cam_tune_radixspline``
keeps the pinned-bits behavior for golden equivalence, and takes the JAX
package's arguments plus ``torch_device`` (the card unless the caller asks
for the CPU).
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import cam
from repro_torch.core.session import DEFAULT_TORCH_DEVICE, System
from repro_torch.core.workload import Workload
from repro_torch.tuning import fit

__all__ = ["RSTuneResult", "profile_radixspline_size_model",
           "cam_tune_radixspline"]


def _deprecated(name: str) -> None:
    warnings.warn(
        f"repro_torch.tuning.rs_tuner.{name} is deprecated; use "
        "repro_torch.tuning.session.TuningSession with a RadixSplineBuilder "
        "(which also tunes radix_bits jointly)",
        DeprecationWarning, stacklevel=3)


@dataclasses.dataclass
class RSTuneResult:
    best_eps: int
    est_io: float
    estimates: Dict[int, cam.CamEstimate]
    size_model: object          # callable knobs -> bytes
    tuning_seconds: float


def profile_radixspline_size_model(
    keys: np.ndarray, sample_eps: Sequence[int] = (16, 64, 256, 1024),
    radix_bits: int = 16,
) -> Tuple[fit.PowerLawFit, float]:
    """Fit M_idx(eps) at fixed ``radix_bits`` (deprecated shim over the 2-D
    :class:`repro_torch.tuning.session.RadixSplineSizeModel`)."""
    _deprecated("profile_radixspline_size_model")
    from repro_torch.index import radixspline
    t0 = time.perf_counter()
    sizes = [radixspline.build_radixspline(keys, e, radix_bits).size_bytes
             for e in sample_eps]
    model = fit.fit_power_law(list(sample_eps), sizes)
    return model, time.perf_counter() - t0


def cam_tune_radixspline(
    keys: np.ndarray,
    positions: np.ndarray,
    memory_budget: float,
    geom: cam.CamGeometry,
    policy: str = "lru",
    eps_grid: Optional[Sequence[int]] = None,
    sample_eps: Sequence[int] = (16, 64, 256, 1024),
    sample_rate: float = 1.0,
    radix_bits: int = 16,
    torch_device: str = DEFAULT_TORCH_DEVICE,
) -> RSTuneResult:
    """Corridor-eps tuning at pinned ``radix_bits`` (deprecated shim)."""
    _deprecated("cam_tune_radixspline")
    from repro_torch.tuning.session import RadixSplineBuilder, TuningSession
    from repro_torch.tuning.pgm_tuner import default_eps_grid

    t0 = time.perf_counter()
    builder = RadixSplineBuilder(keys, tuple(sample_eps),
                                 ref_radix_bits=radix_bits)
    grid = tuple(int(e) for e in eps_grid) if eps_grid is not None \
        else default_eps_grid()
    res = TuningSession(System(geom, memory_budget, policy,
                               torch_device=torch_device)).tune(
        builder, Workload.point(positions, n=len(keys)),
        overrides={"eps": grid, "radix_bits": radix_bits},
        sample_rate=sample_rate)
    # the pinned 2-D space keys estimates by (eps, radix_bits); re-key to
    # the legacy eps-only shape
    estimates = {knob[0]: est for knob, est in res.estimates.items()}
    return RSTuneResult(
        best_eps=int(res.best["eps"]),
        est_io=res.est_io,
        estimates=estimates,
        size_model=res.size_model,
        tuning_seconds=time.perf_counter() - t0,
    )
