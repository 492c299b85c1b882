"""LPM — the Logical Page Model baseline (paper §I, Fig. 1).

LPM predicts physical I/O directly from logical page counts, i.e. it assumes
every logical page reference reaches the device (no buffer).  It is the weak
baseline CAM is compared against: up to 2.6x Q-error on point workloads and
~22x on skewed ones (Tables IV/V), because it ignores cache absorption.
"""
from __future__ import annotations

import numpy as np

__all__ = ["lpm_estimate_from_windows", "lpm_estimate_analytic"]


def lpm_estimate_from_windows(page_lo: np.ndarray, page_hi: np.ndarray) -> float:
    """Mean logical pages per query, counted from actual last-mile windows."""
    widths = np.asarray(page_hi, np.int64) - np.asarray(page_lo, np.int64) + 1
    return float(widths.mean()) if widths.size else 0.0


def lpm_estimate_analytic(eps: int, c_ipp: int, strategy: str = "all_at_once") -> float:
    """Closed-form logical page count (== E[DAC], Lemmas III.2/III.3)."""
    from repro_torch.core import dac

    return float(dac.expected_dac(eps, c_ipp, strategy))
