"""PGM footprints and the power-law size model of section V-B.

Frozen copies of ``repro_torch.index.pla`` (the greedy feasible-slope
eps-PLA), ``repro_torch.index.pgm.build_pgm``'s level recursion and byte
count, and ``repro_torch.tuning.fit.fit_power_law`` at commit
841dd630a0202e497cba3d6a4c1d3efa933a6491.  Only the segment counts are
kept: a level costs 16 bytes a segment.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

SAMPLE_EPS = (16, 64, 256, 1024)


def _segment_end(x: np.ndarray, j: int, eps: float) -> int:
    """End (exclusive) of the greedy segment anchored at ``j``."""
    n = x.shape[0]
    lo_run, hi_run = -np.inf, np.inf
    i = j + 1
    window = 64
    while i < n:
        stop = min(n, i + window)
        dx = (x[i:stop] - x[j]).astype(np.float64)
        dy = np.arange(i - j, stop - j, dtype=np.float64)
        lo_s = np.maximum(np.maximum.accumulate((dy - eps) / dx), lo_run)
        hi_s = np.minimum(np.minimum.accumulate((dy + eps) / dx), hi_run)
        bad = lo_s > hi_s
        if bad.any():
            return i + int(np.argmax(bad))
        lo_run, hi_run = float(lo_s[-1]), float(hi_s[-1])
        i = stop
        window = min(window * 2, 1 << 20)
    return n


def pla_first_keys(keys: np.ndarray, eps: int) -> np.ndarray:
    """Anchor keys of the greedy eps-PLA segments of sorted ``keys``."""
    n = keys.shape[0]
    firsts = []
    j = 0
    while j < n:
        firsts.append(j)
        j = _segment_end(keys, j, float(eps))
    return keys[np.asarray(firsts, np.int64)]


def pgm_size_bytes(keys: np.ndarray, eps: int) -> int:
    """Bytes of a PGM-index at ``eps`` (every level, 16 bytes a segment)."""
    level = pla_first_keys(np.asarray(keys), eps)
    total = level.shape[0]
    while level.shape[0] > 1:
        upper = pla_first_keys(level, max(1, eps))
        total += upper.shape[0]
        if upper.shape[0] >= level.shape[0]:
            break
        level = upper
    return 16 * total


def fit_power_law(eps_samples: Sequence[float], size_samples: Sequence[float],
                  steps: int = 2000, lr: float = 0.05
                  ) -> Tuple[float, float, float]:
    """(a, b, c) of size(eps) = a * eps^-b + c: log-log start, Adam polish."""
    x = np.asarray(eps_samples, np.float64)
    y = np.asarray(size_samples, np.float64)
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
        return torch.mean((torch.exp(log_a) * xt ** (-b) + c - yt) ** 2)

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
    return float(np.exp(log_a)) * scale, float(b), float(c) * scale


def pgm_size_model(keys: np.ndarray):
    """The fitted footprint predictor eps -> bytes, from four PGM builds."""
    sizes = [pgm_size_bytes(keys, e) for e in SAMPLE_EPS]
    a, b, c = fit_power_law(SAMPLE_EPS, sizes)
    return lambda eps: float(a * np.asarray(eps, np.float64) ** (-b) + c)
