"""Page layout + leaf-page fetching strategies (paper §II-B, Fig. 4).

Index-data separation: sorted records live in fixed-size pages on "disk";
the learned index (in memory) yields a position window per lookup, which the
fetch strategy translates into page requests:

* S2 all-at-once — one coalesced read of every page overlapping the window
  (the paper's default; one larger sequential I/O).
* S1 one-by-one  — dependent probes: read the page at the window's lower
  bound, then walk toward the key (sortedness tells the direction after each
  page), stopping at the page containing the true position.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

__all__ = ["PageLayout", "fetch_all_at_once", "fetch_one_by_one_counts"]


@dataclasses.dataclass(frozen=True)
class PageLayout:
    c_ipp: int = 256
    page_bytes: int = 4096

    def num_pages(self, n: int) -> int:
        return -(-n // self.c_ipp)

    def page_of(self, positions: np.ndarray) -> np.ndarray:
        return np.asarray(positions, np.int64) // self.c_ipp


def fetch_all_at_once(
    window_lo: np.ndarray, window_hi: np.ndarray, layout: PageLayout
) -> Tuple[np.ndarray, np.ndarray]:
    """S2: inclusive page interval [page(lo), page(hi)] per query."""
    return layout.page_of(window_lo), layout.page_of(window_hi)


def fetch_one_by_one_counts(
    window_lo: np.ndarray, true_pos: np.ndarray, layout: PageLayout
) -> np.ndarray:
    """S1: pages actually probed walking up from the window's lower bound.

    Matches the Lemma III.3 counting: 1 + floor((offset(lo) + dist)/C_ipp)
    == page(true) - page(lo) + 1.
    """
    start = layout.page_of(window_lo)
    stop = layout.page_of(true_pos)
    return (stop - start + 1).astype(np.int64)
