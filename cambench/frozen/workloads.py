"""Point-query positions of the paper's Table III mixtures (w1-w6).

Frozen copy of ``repro_torch.data.workloads`` (``MIXTURES``,
``WorkloadSpec``, ``point_positions``) at commit
841dd630a0202e497cba3d6a4c1d3efa933a6491.  ``seed`` takes anything
``numpy.random.default_rng`` takes.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np

# (hotspot, zipf, uniform) proportions — Table III.
MIXTURES: Dict[str, Tuple[float, float, float]] = {
    "w1": (0.0, 0.0, 1.0),
    "w2": (0.0, 1.0, 0.0),
    "w3": (1.0, 0.0, 0.0),
    "w4": (0.4, 0.3, 0.3),
    "w5": (0.2, 0.2, 0.6),
    "w6": (0.1, 0.1, 0.8),
}


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    name: str = "w4"
    n_hotspots: int = 8
    hotspot_frac: float = 0.001   # fraction of the position domain per hotspot
    zipf_a: float = 1.3           # numpy zipf shape (a > 1)
    seed: object = 0


def point_positions(n: int, n_queries: int, spec: WorkloadSpec) -> np.ndarray:
    """Query positions (ranks in the sorted key array) of one mixture."""
    mix = MIXTURES[spec.name]
    rng = np.random.default_rng(spec.seed)
    counts = rng.multinomial(n_queries, mix)
    parts = []
    if counts[0]:  # hotspot: uniform inside a few contiguous windows
        width = max(1, int(n * spec.hotspot_frac))
        starts = rng.integers(0, max(1, n - width), size=spec.n_hotspots)
        which = rng.integers(0, spec.n_hotspots, size=counts[0])
        offs = rng.integers(0, width, size=counts[0])
        parts.append(starts[which] + offs)
    if counts[1]:  # zipf over the full domain, scattered by an affine hash
        ranks = rng.zipf(spec.zipf_a, size=counts[1]).astype(np.int64)
        ranks = np.minimum(ranks - 1, n - 1)
        a = 6364136223846793005
        parts.append(((ranks * a + 1442695040888963407) % n).astype(np.int64))
    if counts[2]:  # uniform residual
        parts.append(rng.integers(0, n, size=counts[2]))
    pos = np.concatenate(parts) if parts else np.zeros(0, np.int64)
    rng.shuffle(pos)
    return pos.astype(np.int64)
