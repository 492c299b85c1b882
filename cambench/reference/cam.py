"""CAM's estimate of a tune request, worked out plainly (paper sections IV, III, V).

* Profiles (Eq. 12/13).  A point query at true rank ``r`` under error
  bound ``eps`` searches ``[r + e - eps, r + e + eps]`` for an error ``e``
  uniform on ``[-eps, eps]``; page ``p`` is referenced with probability
  (number of ``e`` whose window meets ``p``) / (2 eps + 1).  The count for
  a query on page ``q`` at offset ``s`` and page ``q + d`` is the length of
  ``[max(-eps, d C - s - eps), min(eps, d C - s + C - 1 + eps)]``; a
  workload's histogram is its (page, offset) occupancy against that table.
  An RMI query takes its leaf's error rounded up to a power of two.
* Hit rates (section III): LRU by Che's characteristic time, FIFO by
  Fricker's fixed point, LFU by the top-C mass; every page distinct in
  the buffer (``C >= N``) leaves only compulsory misses, ``(R - N) / R``;
  no page (``C < 1``) no hits.  Fixed points are solved by bisection to
  float64 resolution.
* The table (section V): each knob's full capacity ``floor((M - size) /
  B)`` first, then each split ``f`` of the budget as ``floor(f M / B)``
  pages where that is at least 1 and below the full capacity; I/O per
  query ``(1 - h) E[DAC]``; the choice is the least I/O.

``dtype`` / ``tf32`` let the control run the same arithmetic in a lower
precision.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

POLICIES = ("lru", "fifo", "lfu")


def lut_radius(eps: int, c_ipp: int) -> int:
    return int(math.ceil(2 * eps / c_ipp))


def point_counts(positions: torch.Tensor, eps: int, c_ipp: int,
                 num_pages: int, dtype=torch.float64) -> torch.Tensor:
    """(num_pages,) expected page references of point queries at ``eps``."""
    dev = positions.device
    d_rad = lut_radius(eps, c_ipp)
    occ = torch.bincount(positions.long(), minlength=num_pages * c_ipp)
    occ = occ[:num_pages * c_ipp].reshape(num_pages, c_ipp).to(dtype)
    d = torch.arange(-d_rad, d_rad + 1, device=dev)[:, None]
    s = torch.arange(c_ipp, device=dev)[None, :]
    lo = torch.clamp(d * c_ipp - s - eps, min=-eps)
    hi = torch.clamp(d * c_ipp - s + c_ipp - 1 + eps, max=eps)
    table = torch.clamp(hi - lo + 1, min=0).to(dtype) / (2 * eps + 1)
    band = table @ occ.T                                   # (2D+1, P)
    out = torch.zeros(num_pages + 2 * d_rad, dtype=dtype, device=dev)
    for j in range(2 * d_rad + 1):
        out[j:j + num_pages] += band[j]
    return out[d_rad:d_rad + num_pages]


def mixed_counts(positions: torch.Tensor, eps_q: np.ndarray, c_ipp: int,
                 num_pages: int, dtype=torch.float64) -> torch.Tensor:
    """Point counts where each query carries its own error bound."""
    eps_t = torch.as_tensor(np.asarray(eps_q, np.int64),
                            device=positions.device)
    out = torch.zeros(num_pages, dtype=dtype, device=positions.device)
    for e in np.unique(eps_q).tolist():
        out += point_counts(positions[eps_t == e], int(e), c_ipp, num_pages,
                            dtype)
    return out


def _bisect(occupancy, probs: torch.Tensor, caps: torch.Tensor,
            iters: int) -> torch.Tensor:
    """Root t of sum(occupancy(probs, t)) = cap for each (row, cap)."""
    hi = torch.ones_like(caps)
    for _ in range(2100):               # grow the bracket past the root
        low = occupancy(probs, hi).sum(-1) < caps
        if not bool(low.any()):
            break
        hi = torch.where(low, 2.0 * hi, hi)
    lo = torch.zeros_like(caps)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        below = occupancy(probs, mid).sum(-1) < caps
        lo = torch.where(below, mid, lo)
        hi = torch.where(below, hi, mid)
    return 0.5 * (lo + hi)


def _che(p, t):
    return -torch.expm1(-p * t[:, None])


def _fifo(p, t):
    pt = p * t[:, None]
    return pt / (1.0 - p + pt)


def hit_rates(counts: torch.Tensor, rows: np.ndarray, caps: np.ndarray,
              pols: Sequence[str], dtype=torch.float64,
              iters: int = 200, block: int = 32) -> np.ndarray:
    """Hit rate of each cell (profile row, capacity, policy)."""
    dev = counts.device
    counts = counts.to(dtype)
    refs = counts.sum(-1)
    n_distinct = (counts > 0).sum(-1).cpu().numpy()
    refs_h = refs.double().cpu().numpy()
    h = np.zeros(len(rows), np.float64)
    solve = []
    for j, (r, c) in enumerate(zip(rows, caps)):
        n = int(n_distinct[r])
        if c < 1 or refs_h[r] <= 0:
            h[j] = 0.0
        elif c >= n:
            h[j] = (refs_h[r] - n) / refs_h[r]
        else:
            solve.append(j)
    for pol in POLICIES:
        cells = [j for j in solve if pols[j] == pol]
        for a in range(0, len(cells), block):
            part = cells[a:a + block]
            rows_t = torch.as_tensor(np.asarray(rows)[part], device=dev)
            probs = (counts[rows_t] / refs[rows_t][:, None])
            cap = torch.as_tensor(np.asarray(caps, np.float64)[part],
                                  dtype=dtype, device=dev)
            if pol == "lfu":
                top = torch.sort(probs, dim=-1, descending=True).values
                rank = torch.arange(probs.shape[1], device=dev)[None, :]
                val = torch.where(rank < cap[:, None], top, 0).sum(-1)
            else:
                occ = _che if pol == "lru" else _fifo
                t = _bisect(occ, probs, cap, iters)
                val = (probs * occ(probs, t)).sum(-1)
            h[part] = val.double().cpu().numpy()
    return h


def table(sizes: Dict[object, float], budget: float, page_bytes: int,
          splits: Sequence[float]) -> List[Tuple[object, float, int]]:
    """The (knob, split, capacity) cells a joint search prices, in order."""
    cells = []
    for knob, size in sizes.items():
        cap_max = int(max(0.0, (budget - size) // page_bytes))
        if cap_max < 1:
            continue
        cells.append((knob, (budget - size) / budget, cap_max))
        for f in splits:
            c = int(f * budget // page_bytes)
            if 1 <= c < cap_max:
                cells.append((knob, f, c))
    return cells
