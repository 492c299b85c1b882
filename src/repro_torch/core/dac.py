"""Expected data-access cost E[DAC] (paper §III-D, Lemmas III.2 / III.3).

The closed forms assume the predicted position lands at a uniformly
distributed in-page offset.  ``*_exact`` variants evaluate the finite sums in
the lemma proofs directly (used by property tests to certify the closed
forms), and the RMI variant computes the workload-weighted leaf mixture of
§V-C.  The closed forms compute in float32, as the JAX reference does; they
return CPU tensors (callers take ``float()`` or ``np.asarray`` of them).
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "expected_dac_all_at_once",
    "expected_dac_one_by_one",
    "expected_dac",
    "expected_dac_all_at_once_exact",
    "expected_dac_one_by_one_exact",
    "expected_dac_rmi",
]

STRATEGIES = ("all_at_once", "one_by_one")


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x), dtype=torch.float32)


def expected_dac_all_at_once(eps, c_ipp):
    """Lemma III.2:  E[DAC] = 1 + 2*eps / C_ipp   (S2 fetching)."""
    return 1.0 + 2.0 * _f32(eps) / _f32(c_ipp)


def expected_dac_one_by_one(eps, c_ipp):
    """Lemma III.3:  E[DAC] = 1 + eps / C_ipp   (S1 fetching)."""
    return 1.0 + _f32(eps) / _f32(c_ipp)


def expected_dac(eps, c_ipp, strategy: str = "all_at_once"):
    if strategy == "all_at_once":
        return expected_dac_all_at_once(eps, c_ipp)
    if strategy == "one_by_one":
        return expected_dac_one_by_one(eps, c_ipp)
    raise ValueError(f"unknown strategy {strategy!r}; expected one of {STRATEGIES}")


# ---------------------------------------------------------------------------
# Exact finite sums from the lemma proofs (test oracles)
# ---------------------------------------------------------------------------

def expected_dac_all_at_once_exact(eps: int, c_ipp: int) -> float:
    """Direct evaluation of the sum in the proof of Lemma III.2."""
    s = np.arange(c_ipp)
    total = 1.0 + np.ceil((eps - s) / c_ipp).clip(min=0)
    total += np.ceil((eps - (c_ipp - 1 - s)) / c_ipp).clip(min=0)
    return float(total.mean())


def expected_dac_one_by_one_exact(eps: int, c_ipp: int) -> float:
    """Direct evaluation of the double sum in the proof of Lemma III.3."""
    x = np.arange(2 * eps + 1)[:, None]
    k = np.arange(c_ipp)[None, :]
    extra = (k + x) // c_ipp
    return float(1.0 + extra.mean())


# ---------------------------------------------------------------------------
# RMI mixture (§V-C): E[DAC] = sum_j w_j (1 + lambda * eps_j / C_ipp)
# ---------------------------------------------------------------------------

def expected_dac_rmi(leaf_eps, leaf_weights, c_ipp, strategy: str = "all_at_once"):
    """Workload-weighted mixture over leaf-local error bounds.

    ``leaf_eps[j]`` is the empirical max error of leaf j, ``leaf_weights[j]``
    the probability a query routes to leaf j (estimated from the workload).
    """
    lam = 2.0 if strategy == "all_at_once" else 1.0
    leaf_eps = _f32(leaf_eps)
    w = _f32(leaf_weights)
    w = w / torch.clamp(torch.sum(w), min=1e-30)
    per_leaf = 1.0 + lam * leaf_eps / _f32(c_ipp)
    return torch.sum(w * per_leaf)
