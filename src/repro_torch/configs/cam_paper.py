"""The paper's own experimental configuration (§VII-A), as data.

Benchmarks import these constants so the mapping from paper setup to our
scaled runs is explicit and greppable; `scale_factor` converts between them.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

__all__ = ["PaperSetup", "PAPER", "SCALED_DEFAULT"]


@dataclasses.dataclass(frozen=True)
class PaperSetup:
    datasets: Tuple[str, ...] = ("books", "fb", "osm", "wiki")
    keys_per_dataset: int = 200_000_000          # 200M uint64 keys
    point_queries: int = 1_000_000
    buffer_bytes: int = 128 * 2**20              # 128 MiB LRU default
    page_bytes: int = 4096
    eps_configurations: int = 9                  # averaged in Tables IV/V
    tuning_budgets_mb: Tuple[int, ...] = (64, 96, 128, 160)
    join_outer: int = 1_000_000
    join_inner: int = 200_000_000
    join_buffer_bytes: int = 16 * 2**20
    workloads: Tuple[str, ...] = ("w1", "w2", "w3", "w4", "w5", "w6")
    default_workload: str = "w4"
    # Table III fitted cost parameters (seconds)
    lambda_point: float = 1.19e-6
    lambda_range: float = 4.66e-7
    alpha: float = 1.64e-6
    beta: float = 1.72e-6
    eta: float = 4.42e-6
    delta: float = 5.00e-3

    def scale_factor(self, our_keys: int) -> float:
        return self.keys_per_dataset / our_keys


PAPER = PaperSetup()

# The scaled defaults of the JAX package's benchmarks (benchmarks/common.py):
# 100x smaller keys, buffer scaled to keep buffer/data ratio in the paper's
# regime.
SCALED_DEFAULT = dataclasses.replace(
    PAPER,
    keys_per_dataset=2_000_000,
    point_queries=200_000,
    buffer_bytes=8 * 2**20,
    tuning_budgets_mb=(1, 2, 3, 4),
    join_outer=30_000,
    join_inner=4_000_000,
    join_buffer_bytes=2 * 2**20,
)
