"""Model fitting utilities (no scipy): power-law index-size fit and OLS.

The PGM tuner (§V-B) fits M_idx(eps) = a * eps^(-b) + c from a handful of
sampled constructions: log-log regression initializes (a, b), then a short
Adam refinement (``torch.autograd`` on the squared loss, float32 as in the
JAX reference) polishes all three parameters — the hand-rolled stand-in for
nonlinear least squares.  The fit is a few scalars over four samples, so it
runs on the CPU whatever the session's device.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

__all__ = ["PowerLawFit", "fit_power_law", "ols"]


@dataclasses.dataclass(frozen=True)
class PowerLawFit:
    a: float
    b: float
    c: float

    def __call__(self, eps) -> np.ndarray:
        return self.a * np.asarray(eps, np.float64) ** (-self.b) + self.c


def fit_power_law(
    eps_samples: Sequence[float],
    size_samples: Sequence[float],
    steps: int = 2000,
    lr: float = 0.05,
) -> PowerLawFit:
    """Fit size(eps) = a * eps^-b + c in log-space with Adam refinement."""
    x = np.asarray(eps_samples, np.float64)
    y = np.asarray(size_samples, np.float64)
    # Init: assume c ~ 0.5 * min(y); log-log regression for a, b.
    c0 = 0.5 * float(y.min())
    ly = np.log(np.maximum(y - c0, 1e-9))
    lx = np.log(x)
    b0 = -float(np.polyfit(lx, ly, 1)[0])
    a0 = float(np.exp(np.polyfit(lx, ly, 1)[1]))

    scale = float(y.mean())
    xt = torch.as_tensor(x, dtype=torch.float32)
    yt = torch.as_tensor(y / scale, dtype=torch.float32)

    def loss(params):
        log_a, b, c = params
        pred = torch.exp(log_a) * xt ** (-b) + c
        return torch.mean((pred - yt) ** 2)

    params = torch.tensor(
        [np.log(max(a0 / scale, 1e-9)), max(b0, 0.05), c0 / scale],
        dtype=torch.float32, requires_grad=True)
    m = torch.zeros(3)
    v = torch.zeros(3)
    for t in range(1, steps + 1):
        (g,) = torch.autograd.grad(loss(params), params)
        with torch.no_grad():
            m = 0.9 * m + 0.1 * g
            v = 0.999 * v + 0.001 * g * g
            mhat = m / (1 - 0.9**t)
            vhat = v / (1 - 0.999**t)
            params -= lr * mhat / (torch.sqrt(vhat) + 1e-8)
    log_a, b, c = params.detach().numpy().astype(np.float64)
    return PowerLawFit(a=float(np.exp(log_a)) * scale, b=float(b), c=float(c) * scale)


def ols(features: np.ndarray, targets: np.ndarray) -> np.ndarray:
    """Least-squares coefficients (design matrix -> coef vector)."""
    coef, *_ = np.linalg.lstsq(np.asarray(features, np.float64),
                               np.asarray(targets, np.float64), rcond=None)
    return coef
