"""Q-error metric (paper §VII-A)."""
from __future__ import annotations

import numpy as np

__all__ = ["q_error", "mean_q_error"]

_EPS = 1e-12


def q_error(estimated, actual) -> np.ndarray:
    """max(est/actual, actual/est), elementwise, guarded against zeros.

    A Q-error of 1.0 means a perfect estimate.  Zero-vs-zero compares as 1.0;
    zero-vs-nonzero is clamped by ``_EPS`` (→ a very large Q-error), matching
    the convention in cardinality-estimation literature.
    """
    est = np.maximum(np.asarray(estimated, np.float64), _EPS)
    act = np.maximum(np.asarray(actual, np.float64), _EPS)
    return np.maximum(est / act, act / est)


def mean_q_error(estimated, actual) -> float:
    return float(np.mean(q_error(estimated, actual)))
