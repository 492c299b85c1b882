"""Device-side I/O cost abstractions CAM composes with (paper §III-A).

CAM's output is an *effective physical I/O count/size*; these models translate
it into device time:

* DAM    — unit cost per block transfer (Aggarwal & Vitter).
* Affine — cost(x) = 1 + alpha * x for an I/O of size x (setup + transfer).
* PDAM   — affine divided by device parallelism P.
* PIO    — parametric read/write asymmetry + concurrency (Papon & Athanassoulis).

All take page-run lengths (contiguous missed-page runs coalesce into one
device I/O under all-at-once fetching) so sequentiality is modeled.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

__all__ = ["DAM", "Affine", "PDAM", "PIO", "runs_from_missed_pages"]


def runs_from_missed_pages(missed_pages: np.ndarray) -> np.ndarray:
    """Lengths of maximal contiguous runs in a sorted array of page ids."""
    pages = np.asarray(missed_pages)
    if pages.size == 0:
        return np.zeros(0, np.int64)
    breaks = np.flatnonzero(np.diff(pages) != 1)
    starts = np.concatenate([[0], breaks + 1])
    ends = np.concatenate([breaks, [pages.size - 1]])
    return (ends - starts + 1).astype(np.int64)


@dataclasses.dataclass(frozen=True)
class DAM:
    """Unit cost per transferred page."""

    def cost(self, run_lengths: Sequence[int]) -> float:
        return float(np.sum(run_lengths))


@dataclasses.dataclass(frozen=True)
class Affine:
    """cost(run of x pages) = 1 + alpha * x (normalized setup + transfer)."""

    alpha: float = 0.25

    def cost(self, run_lengths: Sequence[int]) -> float:
        runs = np.asarray(run_lengths, np.float64)
        return float(np.sum(1.0 + self.alpha * runs))


@dataclasses.dataclass(frozen=True)
class PDAM:
    """Affine with device-level parallelism P (P runs proceed concurrently)."""

    alpha: float = 0.25
    parallelism: int = 8

    def cost(self, run_lengths: Sequence[int]) -> float:
        return Affine(self.alpha).cost(run_lengths) / max(self.parallelism, 1)


@dataclasses.dataclass(frozen=True)
class PIO:
    """Parametric I/O: per-op latency + size/bandwidth with read concurrency."""

    read_setup: float = 1.0
    read_bandwidth_pages: float = 16.0  # pages per time unit
    read_concurrency: int = 8

    def cost(self, run_lengths: Sequence[int]) -> float:
        runs = np.asarray(run_lengths, np.float64)
        per_op = self.read_setup + runs / self.read_bandwidth_pages
        return float(np.sum(per_op)) / max(self.read_concurrency, 1)
