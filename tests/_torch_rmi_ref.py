"""Plain float64 reference of an RMI's page-reference profiles (paper §V-C).

Imports no kernel of the port and no JAX: from an RMI's root line and leaf
error bounds and a batch's keys and true ranks, it gives each candidate's
page counts, total references, E[DAC] and sorted statistics.

* A key ``k`` routes to leaf ``floor((a k + b) * B / n)`` clipped to
  ``[0, B - 1]`` and takes the bound ``e(k) = 2^ceil(log2 max(eps_leaf,
  1))``.
* A point at rank ``r`` under bound ``e`` searches ``[r + x - e, r + x +
  e]`` for an error ``x`` uniform on ``[-e, e]``: page ``p`` gets the
  share of ``x`` whose window meets it (Eq. 12/13), counted here by
  enumerating the window's page span for each ``x``.  Its E[DAC] is the
  batch's leaf mixture ``sum_j w_j (1 + 2 eps_j / C)`` over the
  unquantized leaf bounds.
* A range over ranks ``[lo, hi]`` references each page from
  ``floor(max(0, lo - 2 e(k_lo)) / C)`` to ``floor(min(n - 1, hi + 2
  e(k_hi)) / C)`` once; its E[DAC] mass is that page count.
* Sorted probes take their windows' pages, which no bound moves: coverage,
  references, distinct pages, the junction re-touches ``lo[i+1] == hi[i]``
  and the capacity premise, the widest window in pages.

A mixed batch adds its parts' counts, references and E[DAC] mass.
"""
from __future__ import annotations

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False


def leaf_of(rmi, keys) -> np.ndarray:
    """The leaf each key routes to (``rmi``: root_slope, root_intercept,
    branch, n)."""
    pos = rmi.root_slope * np.asarray(keys).astype(np.float64) \
        + rmi.root_intercept
    leaf = np.floor(pos * rmi.branch / max(rmi.n, 1)).astype(np.int64)
    return np.clip(leaf, 0, rmi.branch - 1)


def bound_of(rmi, keys) -> np.ndarray:
    """``e(k)``: each key's leaf bound rounded up to a power of two."""
    eps = np.maximum(np.asarray(rmi.leaf_eps, np.int64)[leaf_of(rmi, keys)],
                     1)
    return (2 ** np.ceil(np.log2(eps))).astype(np.int64)


def point_counts(ranks, eps, c_ipp: int, num_pages: int) -> np.ndarray:
    """Eq. 12/13 by enumeration: each error ``x`` in ``[-e, e]`` adds
    ``1 / (2e + 1)`` to every page its search window meets (pages past the
    file's ends are dropped)."""
    out = np.zeros(num_pages + 1)
    for e in np.unique(eps):
        r = np.asarray(ranks, np.int64)[eps == e]
        x = np.arange(-e, e + 1)
        lo = (r[:, None] + x[None, :] - e).reshape(-1)
        hi = (r[:, None] + x[None, :] + e).reshape(-1)
        plo = np.clip(np.floor_divide(lo, c_ipp), 0, num_pages)
        phi = np.clip(np.floor_divide(hi, c_ipp), -1, num_pages - 1)
        keep = phi >= plo
        w = 1.0 / (2 * e + 1)
        out += w * (np.bincount(plo[keep], minlength=num_pages + 1)
                    - np.bincount(phi[keep] + 1, minlength=num_pages + 1))
    return np.cumsum(out)[:num_pages]


def point_dac(rmi, keys, c_ipp: int) -> float:
    """E[DAC] of a point batch: the routed leaf mixture (all-at-once)."""
    leaf = leaf_of(rmi, keys)
    w = np.bincount(leaf, minlength=rmi.branch) / max(leaf.shape[0], 1)
    per = 1.0 + 2.0 * np.asarray(rmi.leaf_eps, np.float64) / c_ipp
    return float((w * per).sum())


def range_spans(rmi, lo_keys, hi_keys, lo, hi, c_ipp: int, n: int,
                same_bound: bool = False):
    """Each range's first and last page, each end at its own bound
    (``same_bound``: both at the lower end's, a planted fault)."""
    e_lo = bound_of(rmi, lo_keys)
    e_hi = e_lo if same_bound else bound_of(rmi, hi_keys)
    start = np.maximum(np.asarray(lo, np.int64) - 2 * e_lo, 0) // c_ipp
    end = np.minimum(np.asarray(hi, np.int64) + 2 * e_hi, n - 1) // c_ipp
    return start, end


def sorted_stats(lo, hi, c_ipp: int, num_pages: int) -> dict:
    plo = np.maximum(np.asarray(lo, np.int64), 0) // c_ipp
    phi = np.minimum(np.maximum(
        np.minimum(np.asarray(hi, np.int64), num_pages * c_ipp - 1) // c_ipp,
        plo), num_pages - 1)
    cov = np.cumsum(np.bincount(plo, minlength=num_pages + 1)
                    - np.bincount(phi + 1, minlength=num_pages + 1))
    cov = cov[:num_pages].astype(np.float64)
    return {"coverage": cov, "refs": float(np.sum(phi - plo + 1)),
            "distinct": float(np.count_nonzero(cov)),
            "pinned": float(np.sum(plo[1:] == phi[:-1])),
            "min_cap": int(np.max(phi - plo + 1)),
            "first": int(plo[0]), "last": int(phi[-1])}


def profile(rmi, batch: dict, c_ipp: int, num_pages: int,
            same_bound: bool = False) -> dict:
    """One candidate's profile of a batch.

    ``batch`` maps ``"point"`` to ``(keys, ranks)``, ``"range"`` to
    ``(lo_keys, hi_keys, lo_ranks, hi_ranks)`` and ``"sorted"`` to
    ``(lo_ranks, hi_ranks)``, any of them absent.  Returns ``counts``
    (P,) float64 tensor, ``total`` (IRM references), ``dac`` (E[DAC] per
    query), ``n`` (queries) and ``sorted`` (None or :func:`sorted_stats`).
    """
    n = rmi.n
    counts = np.zeros(num_pages)
    total = dac_mass = 0.0
    nq = 0
    out = {"sorted": None}
    if "point" in batch:
        keys, ranks = batch["point"]
        c = point_counts(ranks, bound_of(rmi, keys), c_ipp, num_pages)
        counts += c
        total += float(c.sum())
        dac_mass += point_dac(rmi, keys, c_ipp) * len(ranks)
        nq += len(ranks)
    if "range" in batch:
        lo_keys, hi_keys, lo, hi = batch["range"]
        start, end = range_spans(rmi, lo_keys, hi_keys, lo, hi, c_ipp, n,
                                 same_bound)
        diff = (np.bincount(start, minlength=num_pages + 1)
                - np.bincount(end + 1, minlength=num_pages + 1))
        counts += np.cumsum(diff)[:num_pages]
        refs = float(np.sum(end - start + 1))
        total += refs
        dac_mass += refs
        nq += len(lo)
    if "sorted" in batch:
        lo, hi = batch["sorted"]
        out["sorted"] = sorted_stats(lo, hi, c_ipp, num_pages)
        dac_mass += out["sorted"]["refs"]
        nq += len(lo)
    out.update(counts=torch.as_tensor(counts, dtype=torch.float64),
               total=total, dac=dac_mass / max(nq, 1), n=nq)
    return out


def window(profiles) -> dict:
    """Profiles of consecutive batches summed as one window: counts,
    references and E[DAC] mass add; sorted statistics add, a junction
    between batches counting as a re-touch, and the premise is the widest."""
    nq = sum(p["n"] for p in profiles)
    out = {"counts": sum(p["counts"] for p in profiles),
           "total": sum(p["total"] for p in profiles),
           "dac": sum(p["dac"] * p["n"] for p in profiles) / max(nq, 1),
           "n": nq, "sorted": None}
    srt = [p["sorted"] for p in profiles if p["sorted"] is not None]
    if srt:
        cov = sum(s["coverage"] for s in srt)
        pinned = sum(s["pinned"] for s in srt) + sum(
            1.0 for a, b in zip(srt, srt[1:]) if b["first"] == a["last"])
        out["sorted"] = {"coverage": cov, "refs": sum(s["refs"] for s in srt),
                         "distinct": float(np.count_nonzero(cov)),
                         "pinned": pinned,
                         "min_cap": max(s["min_cap"] for s in srt)}
    return out
