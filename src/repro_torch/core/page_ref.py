"""Structural page-reference estimators (paper §IV).

Given query *true positions* (ranks) and the index geometry (error bound
``eps``, items-per-page ``C_ipp``), these estimators derive the expected
page-reference histogram ``C_p`` — and from it the request distribution
``Pr_req(p)`` — WITHOUT replaying the workload.

The tensor functions compute on the device of the positions they are given
(float32 histograms, int64 page arithmetic); the numpy functions are the
host-side mixed-eps kernel shared with the ``kernels.profile_grid`` device
path.

* Point queries  — Eq. 12/13 via the (d, s) lookup table (O(eps + C_ipp) entries).
* Range queries  — Eq. 14 via a difference array + prefix sum.
* Sorted (join)  — Theorem III.1 needs only (R, N); computed from interval
  unions with a cummax, no histogram required.
* RMI            — per-leaf mixture: grouped by distinct leaf error bound.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

__all__ = [
    "point_lut",
    "point_page_refs",
    "point_page_refs_grid",
    "point_page_refs_mixed_eps",
    "point_page_refs_mixed_eps_grid",
    "mixed_eps_class_codes",
    "mixed_eps_class_eps",
    "range_page_refs",
    "range_page_refs_grid",
    "page_intervals",
    "sorted_workload_rn",
    "sorted_workload_stats",
    "point_access_prob_exact",
]


def lut_radius(eps: int, c_ipp: int) -> int:
    """Max |page distance| d reachable from the true position's page."""
    return int(np.ceil(2 * eps / c_ipp))


def _segment_sum(values: torch.Tensor, index: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    """``jax.ops.segment_sum``: float32 sums of ``values`` per index."""
    out = torch.zeros(num_segments, dtype=torch.float32, device=values.device)
    return out.scatter_add_(0, index.long(), values.float())


def _lut(eps: torch.Tensor, d_radius: int, c_ipp: int) -> torch.Tensor:
    """Eq. 12 LUT for a (possibly batched) eps tensor and a padded radius.

    Entries with |d| beyond a candidate's own radius get width 0 from the
    max(0, ·) clamp, so padding to the grid-wide max radius is exact.
    """
    dev = eps.device
    d = torch.arange(-d_radius, d_radius + 1, device=dev)[:, None]
    s = torch.arange(c_ipp, device=dev)[None, :]
    eps = eps.long()
    lo = torch.maximum(-eps, d * c_ipp - s - eps)
    hi = torch.minimum(eps, d * c_ipp - s + c_ipp - 1 + eps)
    width = torch.clamp(hi - lo + 1, min=0)
    return width.float() / (2.0 * eps.float() + 1.0)


def point_lut(eps: int, c_ipp: int, device="cpu") -> torch.Tensor:
    """LUT[d + D, s] = Pr(page q+d accessed | in-page offset s) per Eq. 12.

    With the true position r = q*C_ipp + s and the error e ~ U{-eps..eps},
    page p = q + d is touched iff the window [r+e-eps, r+e+eps] intersects
    [p*C_ipp, (p+1)*C_ipp - 1].  Substituting p*C_ipp - r = d*C_ipp - s gives

        L(d,s) = max(-eps, d*C_ipp - s - eps)
        U(d,s) = min(+eps, d*C_ipp - s + C_ipp - 1 + eps)
        Pr     = max(0, U - L + 1) / (2*eps + 1)
    """
    return _lut(torch.tensor(int(eps), device=device),
                lut_radius(eps, c_ipp), c_ipp)


def point_access_prob_exact(r: int, page: int, eps: int, c_ipp: int) -> float:
    """Brute-force enumeration of Eq. 12 (test oracle, O(eps))."""
    hits = 0
    for e in range(-eps, eps + 1):
        w_lo, w_hi = r + e - eps, r + e + eps
        p_lo, p_hi = page * c_ipp, (page + 1) * c_ipp - 1
        if w_lo <= p_hi and p_lo <= w_hi:
            hits += 1
    return hits / (2 * eps + 1)


def point_page_refs(
    positions: torch.Tensor, eps: int, c_ipp: int, num_pages: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expected page-reference histogram for a point workload (Eq. 13).

    Args:
      positions: (Q,) integer true ranks of the query keys.
      eps, c_ipp, num_pages: index geometry.

    Returns:
      counts: (num_pages,) float32 expected reference counts ``C_p``.
      total:  scalar — total expected logical references R (window mass that
              falls on valid pages; boundary-clipped windows drop the
              out-of-range share, matching the clamped last-mile search).
    """
    dev = positions.device
    lut = point_lut(eps, c_ipp, dev)                       # (2D+1, C_ipp)
    d_radius = lut_radius(eps, c_ipp)
    positions = positions.long()
    q = positions // c_ipp
    s = positions % c_ipp
    contribs = lut[:, s].T                                 # (Q, 2D+1)
    targets = q[:, None] + torch.arange(-d_radius, d_radius + 1,
                                        device=dev)[None, :]
    valid = (targets >= 0) & (targets < num_pages)
    contribs = torch.where(valid, contribs, 0.0)
    flat_t = torch.where(valid, targets, 0).reshape(-1)
    counts = _segment_sum(contribs.reshape(-1), flat_t, num_pages)
    return counts, torch.sum(contribs)


def point_page_refs_grid(
    positions: torch.Tensor,
    eps_grid: torch.Tensor,
    d_radius: int,
    c_ipp: int,
    num_pages: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eq. 13 histograms for a WHOLE eps grid in one pass.

    Since every query at true position (q, s) contributes ``LUT[d, s]`` to
    page ``q + d``, the workload enters only through its (page, offset)
    occupancy histogram — computed ONCE and shared by every candidate.  Each
    candidate's page histogram is then a banded contraction

        counts_k[q + d] += sum_s pos_hist[q, s] * LUT_k[d, s]

    i.e. one (K*(2D+1), C_ipp) x (C_ipp, P) matmul plus 2D+1 shifted adds.

    Args:
      positions: (Q,) true ranks, shared page-ref state for the grid.
      eps_grid:  (K,) integer candidate error bounds (same device).
      d_radius:  padded radius — ``lut_radius(max(eps_grid), c_ipp)``.

    Returns:
      counts: (K, num_pages) float32 expected reference histograms.
      totals: (K,) float32 total expected logical references per candidate.
    """
    dev = positions.device
    k = int(eps_grid.shape[0])
    width = 2 * d_radius + 1
    pos_hist = _segment_sum(
        torch.ones(positions.shape[0], device=dev), positions,
        num_pages * c_ipp).reshape(num_pages, c_ipp)      # shared state
    lut = _lut(eps_grid.to(dev)[:, None, None], d_radius,
               c_ipp)                                      # (K, 2D+1, C_ipp)
    # TF32 keeps ~3 decimal digits; the histograms are held to 2e-6, so the
    # banded product runs in full float32 on the card.
    torch.backends.cuda.matmul.allow_tf32 = False
    band = (lut.reshape(k * width, c_ipp) @ pos_hist.T).reshape(
        k, width, num_pages)
    out = torch.zeros((k, num_pages + 2 * d_radius), dtype=torch.float32,
                      device=dev)
    for j in range(width):                                 # shifted adds
        out[:, j:j + num_pages] += band[:, j, :]
    counts = out[:, d_radius:d_radius + num_pages]         # clip to valid pages
    return counts, torch.sum(counts, dim=1)


def range_page_refs_grid(
    lo_pos: torch.Tensor,
    hi_pos: torch.Tensor,
    eps_grid: torch.Tensor,
    c_ipp: int,
    num_pages: int,
    n: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eq. 14 histograms for an eps grid in one pass (cf. point)."""
    dev = lo_pos.device
    eps = eps_grid.to(dev).long()[:, None]                 # (K, 1)
    start = torch.clamp(lo_pos.long()[None, :] - 2 * eps, min=0) // c_ipp
    end = torch.clamp(hi_pos.long()[None, :] + 2 * eps, max=n - 1) // c_ipp
    k = int(eps.shape[0])
    row = torch.arange(k, device=dev)[:, None] * (num_pages + 1)
    ones = torch.ones(start.numel(), device=dev)
    diff = _segment_sum(ones, (row + start).reshape(-1), k * (num_pages + 1))
    diff = diff - _segment_sum(ones, (row + end + 1).reshape(-1),
                               k * (num_pages + 1))
    counts = torch.cumsum(diff.reshape(k, num_pages + 1), dim=1)[:, :num_pages]
    return counts, torch.sum((end - start + 1).float(), dim=1)


def point_page_refs_mixed_eps(
    positions: np.ndarray,
    eps_per_query: np.ndarray,
    c_ipp: int,
    num_pages: int,
    device="cpu",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """RMI variant (§V-C): per-query leaf error bounds.

    Queries are grouped by distinct eps (leaf error bounds repeat heavily),
    and each group reuses the fixed-eps estimator on ``device``.
    """
    positions = np.asarray(positions)
    eps_per_query = np.asarray(eps_per_query)
    counts = torch.zeros((num_pages,), dtype=torch.float32, device=device)
    total = torch.zeros((), dtype=torch.float32, device=device)
    for eps in np.unique(eps_per_query):
        sel = positions[eps_per_query == eps]
        c, t = point_page_refs(torch.as_tensor(sel, device=device),
                               int(max(eps, 1)), c_ipp, num_pages)
        counts = counts + c
        total = total + t
    return counts, total


#: Reusable host buffers for the mixed-eps grid kernel, keyed by
#: (dtype, tag) and grown geometrically.  The kernel is bandwidth-bound and
#: called in a warm tuning loop; fresh mmap-backed temporaries would pay
#: page-fault zeroing on every call.  Bounded by the largest grid profiled
#: (a few tens of MB); single-threaded use, like the session-level caches.
_SCRATCH: dict = {}

#: Max banded entries materialized at once (bounds each scratch buffer).
_SCRATCH_ENTRIES = 2_000_000


def _scratch(dtype, n: int, tag: str = "") -> np.ndarray:
    key = (np.dtype(dtype), tag)
    buf = _SCRATCH.get(key)
    if buf is None or buf.size < n:
        buf = np.empty(int(n * 1.25) + 16, dtype)
        _SCRATCH[key] = buf
    return buf[:n]


@functools.lru_cache(maxsize=256)
def _point_lut_np(eps: int, c_ipp: int) -> np.ndarray:
    """Eq. 12 LUT transposed to (C_ipp, 2D+1), float64, host-side.

    The mixed-eps grid kernel gathers whole LUT rows per reference, so the
    slot axis leads; float64 is deliberate — ``np.bincount`` casts weights
    to float64 internally, so a narrower gather would just add a copy.
    """
    d_radius = lut_radius(eps, c_ipp)
    s = np.arange(c_ipp)[:, None]
    d = np.arange(-d_radius, d_radius + 1)[None, :] * c_ipp
    lo = np.maximum(-eps, d - s - eps)
    hi = np.minimum(eps, d - s + c_ipp - 1 + eps)
    return np.maximum(0, hi - lo + 1) / float(2 * eps + 1)


def mixed_eps_class_codes(
    flat_eps: np.ndarray,
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Eps-class codes shared by the host and device mixed-eps kernels.

    Class codes without a sort over K*Q elements: pow2-quantized bounds
    (the adapters' contract) map to their exponent — popcount(e - 1) —
    while arbitrary bounds (third-party callers) fall back to unique-rank
    codes.  Returns ``(codes, classes)``: ``codes[i]`` is the class code of
    ``flat_eps[i]``; ``classes`` is ``None`` for pow2 inputs (decode with
    :func:`mixed_eps_class_eps`) or the sorted unique eps values otherwise.
    Both kernels MUST group through this one helper so their per-class LUT
    layouts stay aligned.
    """
    flat_eps = np.asarray(flat_eps, np.int64)
    if np.bitwise_and(flat_eps, flat_eps - 1).any():
        classes, codes = np.unique(flat_eps, return_inverse=True)
        if len(classes) <= 256:             # byte compares in the class loop
            codes = codes.astype(np.uint8)
        return codes, classes
    if hasattr(np, "bitwise_count"):
        return np.bitwise_count(flat_eps - 1), None
    codes = np.rint(np.log2(flat_eps.astype(np.float64))).astype(np.uint8)
    return codes, None


def mixed_eps_class_eps(code: int, classes: Optional[np.ndarray]) -> int:
    """Decode a :func:`mixed_eps_class_codes` code back to its eps value."""
    return int(classes[code]) if classes is not None else 1 << int(code)


def point_page_refs_mixed_eps_grid(
    positions: np.ndarray,
    eps_rows: np.ndarray,
    c_ipp: int,
    num_pages: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Mixed-eps histograms for a WHOLE candidate grid in one grouped pass.

    The batched counterpart of :func:`point_page_refs_mixed_eps` for RMI
    branch grids (§V-C): ``eps_rows[k, i]`` is candidate k's error bound for
    the i-th query (its routed leaf's quantized bound), over the SHARED
    ``positions``.  References are grouped by quantized eps ACROSS the whole
    grid — leaf bounds are pow2-quantized, so the union has ~log2(max_eps)
    classes — and each class does one banded LUT-row gather plus one
    ``np.bincount`` into a padded (K, P + 2D) histogram (out-of-range window
    mass lands in the pad and is sliced off, reproducing
    :func:`point_page_refs`'s boundary clipping without a mask).

    This is the golden host kernel (the ``"host"`` profile executor); the
    ``"device"`` executor computes the same histograms with the CUDA kernel
    of ``kernels/profile_grid.py``.

    Returns (counts (K, num_pages) float32, totals (K,) float64).
    """
    positions = np.asarray(positions, np.int64)
    eps_rows = np.maximum(np.asarray(eps_rows, np.int64), 1)
    k, q_n = eps_rows.shape
    if positions.shape[0] != q_n:
        raise ValueError(f"eps_rows has {q_n} columns for "
                         f"{positions.shape[0]} positions")
    page = positions // c_ipp
    slot = positions - page * c_ipp
    max_radius = lut_radius(int(eps_rows.max()), c_ipp)
    pad = num_pages + 2 * max_radius
    counts = np.zeros(k * pad, np.float64)

    codes, classes = mixed_eps_class_codes(eps_rows.ravel())
    # Shared flat arrays: row*pad + page in one precomputed vector, so each
    # class needs exactly two gathers before its banded bincount.  All big
    # temporaries live in the module scratch pool.
    prebase = _scratch(np.int64, k * q_n).reshape(k, q_n)
    np.add(np.arange(k, dtype=np.int64)[:, None] * pad, page[None, :],
           out=prebase)
    prebase = prebase.reshape(-1)
    slot_tiled = _scratch(np.int32, k * q_n).reshape(k, q_n)
    np.copyto(slot_tiled, slot.astype(np.int32)[None, :])
    slot_tiled = slot_tiled.reshape(-1)
    for code in np.flatnonzero(np.bincount(codes)):
        eps = mixed_eps_class_eps(code, classes)
        class_idx = np.flatnonzero(codes == code)
        radius = lut_radius(eps, c_ipp)
        width = 2 * radius + 1
        lut = _point_lut_np(eps, c_ipp)
        offs = np.arange(width)[None, :]
        # Wide-window classes (tiny branch factors) chunk so the scratch
        # pool stays bounded (~30 MB) whatever the grid.
        chunk = max(1, _SCRATCH_ENTRIES // width)
        for a in range(0, class_idx.shape[0], chunk):
            idx = class_idx[a:a + chunk]
            t = idx.shape[0]
            w = _scratch(np.float64, t * width, "w").reshape(t, width)
            np.take(lut, slot_tiled[idx], axis=0, out=w)   # (T, 2D+1) rows
            base = _scratch(np.int64, t, "base")
            np.take(prebase, idx, out=base)
            base += max_radius - radius
            flat = _scratch(np.int64, t * width, "flat").reshape(t, width)
            np.add(base[:, None], offs, out=flat)
            counts += np.bincount(flat.reshape(-1), weights=w.reshape(-1),
                                  minlength=k * pad)
    valid = counts.reshape(k, pad)[:, max_radius:max_radius + num_pages]
    return valid.astype(np.float32), valid.sum(axis=1)


def range_page_refs(
    lo_pos: torch.Tensor,
    hi_pos: torch.Tensor,
    eps: int,
    c_ipp: int,
    num_pages: int,
    n: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Range-workload histogram via Eq. 14 + difference array.

    S(Q) = floor(max(0, r(lo) - 2eps) / C_ipp)
    E(Q) = floor(min(n-1, r(hi) + 2eps) / C_ipp)

    Returns (counts, total_refs R); E[DAC] = R / |Q|.
    """
    start = torch.clamp(lo_pos.long() - 2 * eps, min=0) // c_ipp
    end = torch.clamp(hi_pos.long() + 2 * eps, max=n - 1) // c_ipp
    ones = torch.ones(start.shape[0], device=lo_pos.device)
    diff = _segment_sum(ones, start, num_pages + 1)
    diff = diff - _segment_sum(ones, end + 1, num_pages + 1)
    counts = torch.cumsum(diff, dim=0)[:num_pages]
    total = torch.sum((end - start + 1).float())
    return counts, total


def page_intervals(
    window_lo: torch.Tensor, window_hi: torch.Tensor, c_ipp: int,
    num_pages: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Map position windows to inclusive page intervals (PAGEINTERVALS in Alg. 2)."""
    lo = torch.clamp(window_lo.long(), min=0) // c_ipp
    hi = torch.clamp(window_hi.long(), max=num_pages * c_ipp - 1) // c_ipp
    return lo, torch.minimum(torch.maximum(hi, lo),
                             torch.tensor(num_pages - 1, device=lo.device))


def sorted_workload_rn(
    page_lo: torch.Tensor, page_hi: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(R, N) for a sorted probe stream (Theorem III.1 inputs).

    R = sum of window widths; N = |union of intervals|.  For intervals sorted
    by ``page_lo`` the union size is a running-cummax sweep — O(|Q|), no
    histogram materialization.
    """
    widths = (page_hi - page_lo + 1).float()
    r_total = torch.sum(widths)
    prev_hi = torch.cat([page_hi.new_full((1,), -1),
                         torch.cummax(page_hi, dim=0).values[:-1]])
    new_lo = torch.maximum(page_lo, prev_hi + 1)
    n_distinct = torch.sum(torch.clamp(page_hi - new_lo + 1, min=0).float())
    return r_total, n_distinct


def sorted_workload_stats(
    page_lo: torch.Tensor, page_hi: torch.Tensor, num_pages: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(R, N, coverage, pinned_retouches) for a sorted probe stream.

    Extends :func:`sorted_workload_rn` with the two statistics the
    frequency-aware sorted-scan model (``cache_models.sorted_scan_*``)
    needs beyond Theorem III.1's (R, N):

    * ``coverage`` — the window-coverage histogram ``coverage[p] = number of
      probe windows covering page p`` (difference array + prefix sum, same
      shape as the Eq. 13/14 histograms, so it can also join a mixed
      workload's request distribution);
    * ``pinned_retouches`` — references that survive eviction pressure under
      ANY policy state: a reference to the page the immediately preceding
      reference touched cannot be separated from it by an insertion, so no
      eviction can occur in between.  For a sorted stream this is exactly
      the window-junction count ``sum(lo[i+1] == hi[i])``, the pressure
      correction used by ``cache_models.sorted_scan_misses``.
    """
    lo = page_lo.long()
    hi = page_hi.long()
    ones = torch.ones(lo.shape[0], device=lo.device)
    diff = _segment_sum(ones, lo, num_pages + 1)
    diff = diff - _segment_sum(ones, hi + 1, num_pages + 1)
    coverage = torch.cumsum(diff, dim=0)[:num_pages]
    r_total = torch.sum((hi - lo + 1).float())
    n_distinct = torch.sum(coverage > 0).float()
    pinned = torch.sum((lo[1:] == hi[:-1]).float())
    return r_total, n_distinct, coverage, pinned
