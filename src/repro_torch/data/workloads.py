"""Workload generators (paper §VII-A, Table III).

Point/join probe keys come from a three-component mixture over the key set:
hotspot (contiguous high-skew ranges → locality), Zipf over the full domain
(skew without locality), and a uniform residual.  w1–w6 are the paper's
mixture proportions.  Range workloads pair mixture-sampled lower bounds with
random lengths.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np

__all__ = ["MIXTURES", "WorkloadSpec", "point_positions", "point_workload",
           "range_workload", "join_outer_keys"]

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
    seed: int = 0


def point_positions(n: int, n_queries: int, spec: WorkloadSpec) -> np.ndarray:
    """Sample query *positions* (ranks in the sorted key array)."""
    try:
        mix = MIXTURES[spec.name]
    except KeyError:
        raise ValueError(f"unknown workload {spec.name!r}") from None
    rng = np.random.default_rng(spec.seed)
    counts = rng.multinomial(n_queries, mix)
    parts = []
    if counts[0]:  # hotspot: uniform inside a few contiguous windows
        width = max(1, int(n * spec.hotspot_frac))
        starts = rng.integers(0, max(1, n - width), size=spec.n_hotspots)
        which = rng.integers(0, spec.n_hotspots, size=counts[0])
        offs = rng.integers(0, width, size=counts[0])
        parts.append(starts[which] + offs)
    if counts[1]:  # zipf over the full domain, scattered via permutation hash
        ranks = rng.zipf(spec.zipf_a, size=counts[1]).astype(np.int64)
        ranks = np.minimum(ranks - 1, n - 1)
        # Affine permutation scatters popular ranks across the key space
        # (skew without locality), keeping generation O(Q) and seed-stable.
        a = 6364136223846793005
        parts.append(((ranks * a + 1442695040888963407) % n).astype(np.int64))
    if counts[2]:  # uniform residual
        parts.append(rng.integers(0, n, size=counts[2]))
    pos = np.concatenate(parts) if parts else np.zeros(0, np.int64)
    rng.shuffle(pos)
    return pos.astype(np.int64)


def point_workload(keys: np.ndarray, n_queries: int, spec: WorkloadSpec):
    """(query_keys, true_positions) for a point-lookup workload."""
    pos = point_positions(keys.shape[0], n_queries, spec)
    return keys[pos], pos


def range_workload(
    keys: np.ndarray, n_queries: int, spec: WorkloadSpec, max_len: int = 2048
):
    """(lo_keys, hi_keys, lo_pos, hi_pos) — mixture lows, uniform lengths."""
    n = keys.shape[0]
    rng = np.random.default_rng(spec.seed + 7)
    lo_pos = point_positions(n, n_queries, spec)
    lengths = rng.integers(1, max_len + 1, size=n_queries)
    hi_pos = np.minimum(lo_pos + lengths, n - 1)
    return keys[lo_pos], keys[hi_pos], lo_pos, hi_pos


def join_outer_keys(
    inner_keys: np.ndarray,
    n_outer: int,
    spec: WorkloadSpec,
    miss_frac: float = 0.1,
) -> np.ndarray:
    """Outer relation for A ⋈ B: mixture-sampled inner keys + non-matching
    keys drawn between inner keys (probes that find nothing still do I/O)."""
    rng = np.random.default_rng(spec.seed + 13)
    n_miss = int(n_outer * miss_frac)
    pos = point_positions(inner_keys.shape[0], n_outer - n_miss, spec)
    hits = inner_keys[pos]
    base = inner_keys[
        rng.integers(0, inner_keys.shape[0] - 1, size=n_miss)
    ]
    misses = base + 1  # may or may not exist; realistic near-miss probes
    outer = np.concatenate([hits, misses])
    rng.shuffle(outer)
    return outer
