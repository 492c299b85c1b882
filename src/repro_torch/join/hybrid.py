"""CAM-guided hybrid join: greedy probe partitioning (paper §VI, Algorithm 2).

The sorted probe stream is split into segments; each segment is executed with
point probes or one coalesced range probe, whichever the fitted cost model
(Eq. 17) predicts cheaper:

    Cost_point(S) = delta + alpha * N_S + lambda_point * miss_S
    Cost_range(S) = eta + (beta + lambda_range) * K_S

miss_S is CAM's cache-aware physical-miss estimate for point-probing the
segment: with enough buffer capacity for one probe window (the Theorem III.1
premise) it is d_S, the distinct-page union — one compulsory miss per
distinct page; below that capacity every logical reference misses, so
miss_S = R_S, the segment's total window mass.  Under frequency-based
eviction (LFU) the session scales lambda_point by the shared sorted-scan
model's miss/compulsory ratio (``cache_models.sorted_scan_misses`` — see
``JoinSession._policy_miss_scale``) before partitioning, so the point/range
decisions price the same policy pathology the estimator predicts.  The
greedy pass closes a segment when its range span hits K_max or range probing
wins by margin gamma once N_min probes have accumulated.

``partition_probes`` is the vectorized two-pass kernel (prefix-scan
distinct-page union + segment-boundary selection over numpy arrays, scanned
in geometrically growing chunks); ``partition_probes_loop`` keeps the
original per-probe Python loop as the golden reference.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

__all__ = ["JoinCostParams", "Segment", "partition_probes",
           "partition_probes_loop", "segment_costs"]


@dataclasses.dataclass(frozen=True)
class JoinCostParams:
    """Eq. 17 coefficients (fit by calibration, see join/calibrate.py)."""

    alpha: float = 1.64e-6         # per-key CPU
    beta: float = 1.72e-6          # per-page scan/filter CPU
    delta: float = 0.30e-6         # point-probe intercept
    eta: float = 4.42e-6           # range-probe intercept
    lambda_point: float = 11.9e-6  # per physical miss (random)
    lambda_range: float = 4.66e-6  # per physical miss (sequential)
    sort_per_key: float = 0.12e-6  # outer-relation sort, amortized per key


@dataclasses.dataclass(frozen=True)
class Segment:
    start: int          # probe index range [start, end)
    end: int
    page_lo: int        # page span covered by the range probe
    page_hi: int
    n_keys: int
    distinct_pages: int
    use_range: bool
    cost_point: float
    cost_range: float
    total_refs: int = 0  # sum of per-probe window widths (R_S)


def segment_costs(
    n_keys: int, distinct_pages: int, span: int, params: JoinCostParams
) -> Tuple[float, float]:
    cost_p = params.delta + params.alpha * n_keys + params.lambda_point * distinct_pages
    cost_r = params.eta + (params.beta + params.lambda_range) * span
    return cost_p, cost_r


def partition_probes_loop(
    page_lo: np.ndarray,
    page_hi: np.ndarray,
    params: JoinCostParams,
    n_min: int = 1024,
    k_max: int = 8192,
    gamma: float = 0.05,
    thrash: bool = False,
) -> List[Segment]:
    """Algorithm 2 as the original per-probe Python loop (golden reference)."""
    lo = np.asarray(page_lo, np.int64)
    hi = np.asarray(page_hi, np.int64)
    n = lo.shape[0]
    segments: List[Segment] = []
    i = 0
    while i < n:
        seg_lo = int(lo[i])
        seg_hi = int(hi[i])
        covered_hi = int(hi[i])          # rightmost page seen (for distinct count)
        distinct = seg_hi - seg_lo + 1
        refs = seg_hi - seg_lo + 1
        j = i + 1
        while j < n:
            l, h = int(lo[j]), int(hi[j])
            new_lo = min(seg_lo, l)
            new_hi = max(seg_hi, h)
            # incremental distinct-page union (sorted stream => windows only
            # extend to the right of what previous windows covered)
            distinct += max(0, h - max(l, covered_hi + 1) + 1)
            refs += h - l + 1
            covered_hi = max(covered_hi, h)
            seg_lo, seg_hi = new_lo, new_hi
            n_keys = j - i + 1
            span = seg_hi - seg_lo + 1
            if n_keys >= n_min:
                miss = refs if thrash else distinct
                cost_p, cost_r = segment_costs(n_keys, miss, span, params)
                if span >= k_max or cost_r <= (1.0 - gamma) * cost_p:
                    j += 1
                    break
            j += 1
        n_keys = j - i
        span = seg_hi - seg_lo + 1
        miss = refs if thrash else distinct
        cost_p, cost_r = segment_costs(n_keys, miss, span, params)
        use_range = (n_keys >= n_min) and (cost_r <= (1.0 - gamma) * cost_p)
        segments.append(Segment(i, j, seg_lo, seg_hi, n_keys, distinct,
                                use_range, cost_p, cost_r, refs))
        i = j
    return segments


def partition_probes(
    page_lo: np.ndarray,
    page_hi: np.ndarray,
    params: JoinCostParams,
    n_min: int = 1024,
    k_max: int = 8192,
    gamma: float = 0.05,
    thrash: bool = False,
) -> List[Segment]:
    """Algorithm 2, vectorized: per-probe work becomes prefix scans.

    Segment boundaries are inherently sequential (each segment's start is the
    previous one's end), but everything *inside* a segment is a prefix
    computation over the probe stream: the covered-page frontier is a running
    max of ``page_hi``, the distinct-page union is a cumulative sum of
    clamped window increments against that frontier, and the close condition
    is an elementwise predicate.  So the kernel scans forward from each
    segment start in geometrically growing numpy chunks — pass 1 builds the
    prefix scans for the chunk, pass 2 selects the first index where the
    close predicate fires — and only the (rare) segment boundaries run in
    Python.  Every segment except the last holds >= n_min probes, so the
    boundary loop executes at most ceil(n / n_min) + 1 times.

    ``thrash=True`` composes Eq. 17 with CAM's below-capacity regime: when
    the buffer cannot hold one probe window, every logical reference is a
    physical miss, so the point-cost miss term uses R_S instead of d_S
    (see JoinSession, which sets this from the Theorem III.1 premise).

    Output is segment-for-segment identical to ``partition_probes_loop``.
    """
    lo = np.asarray(page_lo, np.int64)
    hi = np.asarray(page_hi, np.int64)
    n = lo.shape[0]
    widths = hi - lo + 1
    lam_r = params.beta + params.lambda_range
    segments: List[Segment] = []
    i = 0
    while i < n:
        # carry state: segment stats over [i, pos) so far
        pos = i + 1
        seg_lo = int(lo[i])
        cm = int(hi[i])                     # covered frontier == running max hi
        distinct = int(cm - seg_lo + 1)
        refs = distinct
        end = None
        chunk = max(int(n_min), 256)
        while pos < n and end is None:
            a, b = pos, min(n, pos + chunk)
            l, h = lo[a:b], hi[a:b]
            inc_cm = np.maximum.accumulate(h)           # frontier incl. probe
            prev_cm = np.empty_like(inc_cm)             # frontier before probe
            prev_cm[0] = cm
            np.maximum(inc_cm[:-1], cm, out=prev_cm[1:])
            inc_cm = np.maximum(inc_cm, cm)
            run_lo = np.minimum.accumulate(l)
            np.minimum(run_lo, seg_lo, out=run_lo)
            d_cum = distinct + np.cumsum(
                np.maximum(0, h - np.maximum(l, prev_cm + 1) + 1))
            r_cum = refs + np.cumsum(widths[a:b])
            n_keys = np.arange(a - i + 1, b - i + 1)
            span = inc_cm - run_lo + 1
            miss = r_cum if thrash else d_cum
            cost_p = params.delta + params.alpha * n_keys \
                + params.lambda_point * miss
            cost_r = params.eta + lam_r * span
            stop = (n_keys >= n_min) & ((span >= k_max)
                                        | (cost_r <= (1.0 - gamma) * cost_p))
            k = int(np.argmax(stop))
            if stop[k]:
                end = a + k + 1
            else:
                k = b - a - 1                           # chunk exhausted: carry
                pos = b
                chunk *= 2
            seg_lo = int(run_lo[k])
            cm = int(inc_cm[k])
            distinct = int(d_cum[k])
            refs = int(r_cum[k])
        end = n if end is None else end
        n_keys = end - i
        span = cm - seg_lo + 1
        miss = refs if thrash else distinct
        cost_p, cost_r = segment_costs(n_keys, miss, span, params)
        use_range = (n_keys >= n_min) and (cost_r <= (1.0 - gamma) * cost_p)
        segments.append(Segment(i, end, seg_lo, cm, n_keys, distinct,
                                use_range, cost_p, cost_r, refs))
        i = end
    return segments
