"""Simulated execution machine: buffered disk + timing model.

The paper measures wall-clock on a real NVMe SSD; the repo has no disk under
test, so execution benchmarks run against a deterministic simulated
machine whose *hidden* ground-truth constants play the role of the hardware.
Physical I/O counts are exact (they come from real replay through the eviction
policy); time is physical-miss latency + CPU terms with the magnitudes of the
paper's fitted Table III parameters.  The join cost model (Eq. 17) is then
*calibrated against this machine* exactly the way the paper calibrates against
its server — the tuning/join experiments compare strategies, not absolute
seconds.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import replay as replay_mod

__all__ = ["MachineParams", "BufferedDisk", "simulate_point_queries"]


@dataclasses.dataclass(frozen=True)
class MachineParams:
    """Hidden ground-truth constants (seconds) — Table III magnitudes."""

    cpu_per_key: float = 1.64e-6          # traversal + last-mile + buffer mgmt
    cpu_per_page_scan: float = 1.72e-6    # range scan + filtering per page
    range_op_setup: float = 4.42e-6       # per coalesced range-probe op
    point_op_setup: float = 0.30e-6       # per point-probe op
    miss_latency_point: float = 11.9e-6   # physical page miss, random read
    miss_latency_range: float = 4.66e-6   # physical page miss, sequential read
    sort_per_key: float = 0.12e-6         # outer-relation sort amortized / key


class BufferedDisk:
    """Data pages behind a self-managed page buffer (FIFO/LRU/LFU)."""

    def __init__(self, num_pages: int, capacity: int, policy: str = "lru"):
        self.num_pages = int(num_pages)
        self.capacity = int(max(1, capacity))
        self.policy = policy
        self.buffer = replay_mod.make_buffer(policy, self.capacity)
        self.physical_reads = 0
        self.logical_reads = 0

    def fetch_window(self, page_lo: int, page_hi: int) -> int:
        """Fetch pages [lo, hi]; returns physical misses for this request."""
        misses = 0
        access = self.buffer.access
        for page in range(page_lo, page_hi + 1):
            if not access(page):
                misses += 1
        count = page_hi - page_lo + 1
        self.logical_reads += count
        self.physical_reads += misses
        return misses


def simulate_point_queries(
    page_lo: np.ndarray,
    page_hi: np.ndarray,
    capacity: int,
    policy: str,
    machine: MachineParams = MachineParams(),
):
    """Execute a point workload; returns (total_seconds, qps, total_misses)."""
    misses = replay_mod.replay_windows(page_lo, page_hi, capacity, policy)
    total_misses = int(misses.sum())
    n = len(page_lo)
    seconds = (
        n * (machine.cpu_per_key + machine.point_op_setup)
        + total_misses * machine.miss_latency_point
    )
    return seconds, n / max(seconds, 1e-12), total_misses
