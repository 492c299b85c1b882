"""Policy-specific buffer hit-rate models (paper §III-B, §III-C).

All estimators operate on a page-request probability tensor ``probs``
(``Pr_req(i)`` in the paper) and a buffer capacity ``C`` in pages, on the
device of ``probs``.  The fixed-point solves use a fixed-iteration bisection
(monotone objectives); the batched forms carry a leading candidate axis and
run every candidate's bisection in lockstep.

Models implemented
------------------
* ``hit_rate_lru``  — Che's approximation (Eq. 7/8).
* ``hit_rate_fifo`` — Fricker's fixed point (Eq. 4/5/6); equals RANDOM under IRM.
* ``hit_rate_lfu``  — converged top-C mass (Eq. 9).
* ``hit_rate_compulsory`` — ``(R - N) / R`` for the large-capacity case and for
  sorted workloads under recency eviction (Theorem III.1).
* ``sorted_scan_misses`` / ``sorted_scan_hit_rate`` / the batched
  ``sorted_scan_hit_rate_grid`` — the policy-aware sorted-scan family: the
  compulsory closed form where Theorem III.1's premises hold (recency
  eviction, capacity above one probe window), a frequency-aware closed form
  from the window-coverage histogram for LFU-like policies, and the thrash
  regime below the capacity premise.

Dtypes follow the JAX reference, which runs with x64 off: float32 math and
int32 regime compares (``_exact_caps``); a float64 ``probs`` keeps float64
in the single-candidate solvers, as there.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

__all__ = [
    "solve_che_time",
    "hit_rate_lru",
    "solve_fifo_tau",
    "hit_rate_fifo",
    "hit_rate_lfu",
    "hit_rate_compulsory",
    "hit_rate",
    "hit_rate_grid",
    "writeback_fraction",
    "sorted_scan_misses",
    "sorted_scan_hit_rate",
    "sorted_scan_hit_rate_grid",
    "sorted_scan_miss_curve",
    "hit_rate_curve",
    "POLICIES",
    "RECENCY_POLICIES",
]

POLICIES = ("lru", "fifo", "lfu")

#: Policies whose eviction order tracks recency.  For these Theorem III.1's
#: proof step — "no page of the current probe window is evicted before the
#: probe finishes" — holds whenever the buffer fits one window, so the
#: compulsory closed form is exact for sorted streams.  Frequency-based
#: policies (LFU) violate it: stale high-frequency pages pin buffer slots and
#: the advancing scan frontier is evicted (with its frequency reset), so they
#: take the frequency-aware form below instead.
RECENCY_POLICIES = ("lru", "fifo")

_BISECT_ITERS = 64  # float32 bisection converges long before this

#: Largest capacity the exact compare path represents (int32).  Saturating
#: here is lossless for regime dispatch: every distinct-page count is far
#: below it, so any saturated capacity is already in the compulsory regime.
_CAP_MAX = 2**31 - 129


def _tensor(x, device=None) -> torch.Tensor:
    """``x`` as a tensor; numpy float64 arrays become float32 (JAX's
    ``jnp.asarray`` with x64 off), integer arrays become int64."""
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(device)
    arr = np.asarray(x)
    if arr.dtype.kind == "f":
        return torch.as_tensor(arr, dtype=torch.float32, device=device)
    return torch.as_tensor(arr.astype(np.int64), device=device)


def _exact_caps(values, device=None) -> torch.Tensor:
    """Integer-exact page counts for regime compares.

    float32 represents integers exactly only up to 2^24 (a 64 GiB pool at
    4 KiB pages), so ``capacity >= n_distinct``-style compares on float32
    capacities can flip on the rounded value.  Integer inputs pass through
    as int32 (exact to 2^31 pages); float inputs floor — for an integral
    threshold ``floor(c) >= n`` iff ``c >= n`` and ``floor(c) < n`` iff
    ``c < n`` — so float callers keep their semantics while integer callers
    gain exact compares.  Saturates at ``_CAP_MAX`` to keep the float→int
    conversion defined.
    """
    arr = _tensor(values, device)
    if not arr.is_floating_point():
        return torch.clamp(arr.long(), max=_CAP_MAX).int()
    return torch.clamp(torch.floor(arr), -1.0, float(_CAP_MAX)).int()


def _bisect(f, lo: torch.Tensor, hi: torch.Tensor,
            iters: int = _BISECT_ITERS) -> torch.Tensor:
    """Fixed-iteration bisection for a monotone-increasing objective
    (elementwise over any batch shape of ``lo``/``hi``)."""
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        below = f(mid) < 0.0
        lo = torch.where(below, mid, lo)
        hi = torch.where(below, hi, mid)
    return 0.5 * (lo + hi)


def _float(probs) -> torch.Tensor:
    probs = _tensor(probs)
    return probs if probs.dtype == torch.float64 else probs.float()


def _bracket(probs: torch.Tensor, capacity: torch.Tensor):
    """Bisection bracket ``[0, max(4C/p_min, 1)]`` over the last axis."""
    inf = torch.tensor(float("inf"), dtype=probs.dtype, device=probs.device)
    pmin = torch.clamp(torch.amin(torch.where(probs > 0, probs, inf),
                                  dim=-1), min=1e-30)
    hi = torch.clamp(4.0 * capacity / pmin, min=1.0)
    return torch.zeros_like(hi), hi


# ---------------------------------------------------------------------------
# LRU — Che's approximation
# ---------------------------------------------------------------------------

def _che_occ(probs: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return -torch.expm1(-probs * t[..., None])


def _fifo_occ(probs: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    pt = probs * t[..., None]
    return pt / (1.0 - probs + pt)


def solve_che_time(probs, capacity) -> torch.Tensor:
    """Characteristic time T_C from the consistency condition (Eq. 8):

        C = sum_i (1 - exp(-p_i * T_C))

    The RHS is monotone increasing in ``T_C`` and saturates at ``N`` (the
    number of pages with nonzero probability), so a solution exists whenever
    ``C < N``; callers handle ``C >= N`` via :func:`hit_rate_compulsory`.
    ``probs`` may carry leading batch axes; ``capacity`` broadcasts to them.
    """
    probs = _float(probs)
    capacity = torch.as_tensor(capacity, dtype=probs.dtype,
                               device=probs.device)
    lo, hi = _bracket(probs, capacity)
    return _bisect(lambda t: torch.sum(_che_occ(probs, t), dim=-1) - capacity,
                   lo, hi)


def hit_rate_lru(probs, capacity, use_kernel: bool = False) -> torch.Tensor:
    """Che's approximation for LRU (Eq. 7).

    ``use_kernel=True`` names the multi-candidate Che-sums kernel, which has
    not been ported to CUDA yet: it raises instead of running something else.
    """
    if use_kernel:
        raise NotImplementedError(
            "hit_rate_lru(use_kernel=True) needs the che_sums kernel, which "
            "the CUDA port does not have yet; call with use_kernel=False")
    probs = _float(probs)
    t_c = solve_che_time(probs, capacity)
    return torch.sum(probs * _che_occ(probs, t_c), dim=-1)


# ---------------------------------------------------------------------------
# FIFO — Fricker's fixed point (== RANDOM under IRM)
# ---------------------------------------------------------------------------

def solve_fifo_tau(probs, capacity) -> torch.Tensor:
    """Characteristic time tau_C from the consistency condition (Eq. 5):

        C = sum_i p_i * tau / (1 - p_i + p_i * tau)

    Monotone increasing in ``tau`` with limit ``N``; bisection as for Che.
    """
    probs = _float(probs)
    capacity = torch.as_tensor(capacity, dtype=probs.dtype,
                               device=probs.device)
    lo, hi = _bracket(probs, capacity)
    return _bisect(lambda t: torch.sum(_fifo_occ(probs, t), dim=-1) - capacity,
                   lo, hi)


def hit_rate_fifo(probs, capacity) -> torch.Tensor:
    """Fricker's FIFO/RANDOM stationary hit rate (Eq. 4 + Eq. 6)."""
    probs = _float(probs)
    tau = solve_fifo_tau(probs, capacity)
    return torch.sum(probs * _fifo_occ(probs, tau), dim=-1)


# ---------------------------------------------------------------------------
# LFU — converged steady state
# ---------------------------------------------------------------------------

def _top_mass(sorted_desc: torch.Tensor, capacity) -> torch.Tensor:
    """Mass of the first ``clip(capacity, 0, P)`` entries of each row of a
    descending-sorted tensor (the capacity truncates toward zero)."""
    n = sorted_desc.shape[-1]
    cap = torch.as_tensor(capacity, device=sorted_desc.device)
    cap = torch.clamp(cap, 0, n).long()
    ranks = torch.arange(n, device=sorted_desc.device)
    mask = ranks < cap[..., None]
    return torch.sum(torch.where(mask, sorted_desc, 0.0), dim=-1)


def hit_rate_lfu(probs, capacity) -> torch.Tensor:
    """Converged LFU keeps the C most popular pages (Eq. 9)."""
    probs = _tensor(probs)
    sorted_p = torch.sort(probs, dim=-1, descending=True, stable=True).values
    return _top_mass(sorted_p, capacity)


# ---------------------------------------------------------------------------
# Dirty-page writeback — the second physical-I/O stream of a mutating mix
# ---------------------------------------------------------------------------

def _writeback_terms(policy: str, probs: torch.Tensor, wprobs: torch.Tensor,
                     capacity) -> torch.Tensor:
    """Expected writebacks per reference for (histogram, capacity) cells.

    A write dirties its page in the pool; the dirty bit is flushed (one
    physical write I/O) when the page is EVICTED — so the writeback stream
    is the dirty-eviction rate, computable from the SAME characteristic-time
    fixed point the hit rate already solves:

    * page ``i``'s eviction rate equals its insertion (miss) rate,
      ``q_i * (1 - o_i)`` per reference, with ``q_i`` the combined
      read+write reference probability and ``o_i`` the policy occupancy
      (Che Eq. 7 for LRU, Fricker Eq. 4 for FIFO);
    * the evicted copy is dirty iff its residency started with a write
      (prob ``w_i / q_i``) or a write arrived during the residency window
      ``T`` (prob ``1 - exp(-w_i * T)`` for a read-born copy), giving

          wb = sum_i (1 - o_i) * (w_i + r_i * (1 - exp(-w_i * T))),
          r_i = q_i - w_i.

    Converged LFU never evicts its top-C pages, so its writeback is exactly
    the write mass landing OUTSIDE the retained set — the write-mass prefix
    sum under the combined-popularity order, whose ties break as a STABLE
    descending sort does (``torch.argsort(..., stable=True)``, matching
    ``jnp.argsort``), which keeps host and device executors aligned.
    Leading axes of ``probs``/``wprobs``/``capacity`` are batch axes.
    """
    probs = _tensor(probs)
    wprobs = _tensor(wprobs)
    if policy == "lfu":
        order = torch.argsort(-probs, dim=-1, stable=True)
        w_sorted = torch.gather(wprobs.expand_as(probs), -1, order)
        prefix = torch.cumsum(w_sorted, dim=-1)
        cap = torch.clamp(torch.as_tensor(capacity, device=probs.device), 0,
                          probs.shape[-1]).int().long()
        idx = torch.clamp(cap - 1, min=0)
        kept = torch.gather(prefix, -1, idx[..., None].expand(
            prefix.shape[:-1] + (1,)))[..., 0]
        kept = torch.where(cap > 0, kept, 0.0)
        return torch.sum(wprobs, dim=-1) - kept
    if policy == "lru":
        t = solve_che_time(probs, capacity)
        occ = _che_occ(probs, t)
    elif policy == "fifo":
        t = solve_fifo_tau(probs, capacity)
        occ = _fifo_occ(probs, t)
    else:
        raise ValueError(f"unknown policy {policy!r}; "
                         f"expected one of {POLICIES}")
    r = torch.clamp(probs - wprobs, min=0.0)
    dirty = wprobs + r * -torch.expm1(-wprobs * t[..., None])
    return torch.sum((1.0 - occ) * dirty, dim=-1)


def writeback_fraction(policy: str, probs, wprobs, capacity,
                       n_distinct=None) -> torch.Tensor:
    """Regime-dispatched :func:`_writeback_terms` for one candidate.

    ``probs`` is the COMBINED read+write reference-probability vector,
    ``wprobs`` its write component.  Above ``N`` distinct pages nothing is
    ever evicted, so steady-state writeback is zero; below one page every
    write flushes through.  Subtracting the result from the hit rate prices
    the mix: ``io = (1 - (h - wb)) * E[DAC]`` counts fetches AND flushes per
    reference.
    """
    probs = _tensor(probs).float()
    wprobs = _tensor(wprobs, probs.device).float()
    dev = probs.device
    nd = (torch.sum(probs > 0) if n_distinct is None
          else _tensor(n_distinct, dev))
    cap_i = _exact_caps(capacity, dev)
    cap_f = torch.clamp(torch.as_tensor(capacity, dtype=torch.float32,
                                        device=dev), min=1.0)
    wb = _writeback_terms(policy, probs, wprobs, cap_f)
    wb = torch.where(cap_i >= _exact_caps(nd, dev), 0.0, wb)
    return torch.where(cap_i < 1, torch.sum(wprobs), wb)


# ---------------------------------------------------------------------------
# Compulsory-miss closed form (C >= N, and sorted workloads via Thm III.1)
# ---------------------------------------------------------------------------

def hit_rate_compulsory(total_requests, distinct_pages) -> torch.Tensor:
    """h = (R - N) / R — each distinct page misses exactly once."""
    r = torch.as_tensor(total_requests, dtype=torch.float32)
    n = torch.as_tensor(distinct_pages, dtype=torch.float32, device=r.device)
    return torch.where(r > 0, (r - n) / torch.clamp(r, min=1.0), 0.0)


# ---------------------------------------------------------------------------
# Sorted-scan model family (Theorem III.1 + policy-aware extensions)
# ---------------------------------------------------------------------------

def _desc_prefix(coverage: torch.Tensor) -> torch.Tensor:
    """Descending-coverage prefix sums over the last axis."""
    return torch.cumsum(
        torch.sort(coverage, dim=-1, descending=True).values, dim=-1)


def _sorted_scan_misses_freq(coverage, capacity,
                             pinned_retouches) -> torch.Tensor:
    """Frequency-aware sorted-scan miss count from the coverage histogram.

    A frequency-based cache breaks the recency premise of Theorem III.1 in a
    specific way: eviction resets a page's frequency, so the advancing scan
    frontier keeps being evicted by stale pages whose counts were accumulated
    earlier, and re-misses on re-entry.  Two hit sources survive this
    pathology, and each yields a closed-form hit lower bound:

    * steady-state retention — the converged cache keeps the ``C`` pages
      with the highest coverage (Eq. 9 applied to the coverage histogram),
      whose references hit once resident: ``miss <= R - topC_mass``;
    * pressure-pinned re-touches — the window-junction count
      ``pinned = sum(lo[i+1] == hi[i])`` (see
      ``page_ref.sorted_workload_stats``): those references hit under ANY
      eviction state, so ``miss <= R - pinned``.

    The model takes the tighter bound and clamps to ``[N, R]`` (compulsory
    floor, thrash ceiling).  Leading axes are batch axes.
    """
    cov = _tensor(coverage).float()
    return _freq_misses_from_prefix(
        _desc_prefix(cov), torch.sum(cov, dim=-1),
        torch.sum(cov > 0, dim=-1).float(), capacity, pinned_retouches)


def _freq_misses_from_prefix(prefix, r, n, capacity, pinned_retouches):
    """Frequency-aware miss count given the descending-coverage prefix sums
    (``prefix[..., k-1]`` = mass of the k most-covered pages) — the
    O(P log P) sort is hoisted here so a knob grid over one shared stream
    pays it once, not once per candidate."""
    dev = prefix.device
    cap = torch.clamp(_tensor(capacity, dev), 0, prefix.shape[-1]).long()
    batch = torch.broadcast_shapes(cap.shape, prefix.shape[:-1])
    idx = torch.clamp(cap - 1, min=0).expand(batch)[..., None]
    topc = torch.gather(prefix.expand(batch + prefix.shape[-1:]), -1,
                        idx)[..., 0]
    topc = torch.where(cap > 0, topc, 0.0)
    r = _tensor(r, dev).float()
    steady = r - topc
    pinned = r - _tensor(pinned_retouches, dev).float()
    n = _tensor(n, dev).float()
    return torch.minimum(torch.maximum(torch.minimum(steady, pinned), n), r)


def sorted_scan_misses(
    policy: str,
    capacity,
    *,
    total_refs: float,
    distinct_pages: float,
    coverage: Optional[torch.Tensor] = None,
    pinned_retouches: float = 0.0,
    min_capacity: int = 1,
) -> float:
    """Expected physical misses of a sorted one-pass probe stream.

    The policy-aware dispatch for sorted workloads:

    * ``capacity < min_capacity`` — the buffer cannot hold one probe window
      (Theorem III.1's capacity premise fails): every reference except the
      pressure-pinned window-junction re-touches misses,
      ``miss = R - pinned`` (thrash regime);
    * recency policies, ``capacity >= N``, or no coverage histogram — the
      compulsory closed form, ``miss = N`` (Theorem III.1);
    * frequency-based policies below ``N`` — the frequency-aware closed form
      of :func:`_sorted_scan_misses_freq` on the window-coverage histogram.
    """
    r = float(total_refs)
    n = float(distinct_pages)
    if r <= 0.0:
        return 0.0
    if capacity is not None and capacity < min_capacity:
        return min(max(r - float(pinned_retouches), n), r)
    if (policy in RECENCY_POLICIES or coverage is None
            or capacity is None or capacity >= n):
        return n
    return float(_sorted_scan_misses_freq(coverage, capacity,
                                          pinned_retouches))


def sorted_scan_hit_rate(
    policy: str,
    capacity,
    *,
    total_refs: float,
    distinct_pages: float,
    coverage: Optional[torch.Tensor] = None,
    pinned_retouches: float = 0.0,
    min_capacity: int = 1,
) -> float:
    """Hit rate of a sorted probe stream: ``(R - miss) / R``.

    Shares :func:`hit_rate_compulsory`'s zero-guards, so boundary estimates
    (R ~ 0, capacity at the thrash edge) agree everywhere — for recency
    policies above the capacity premise this IS ``hit_rate_compulsory``.
    """
    r = float(total_refs)
    if r <= 0.0:
        return 0.0
    miss = sorted_scan_misses(
        policy, capacity, total_refs=r, distinct_pages=distinct_pages,
        coverage=coverage, pinned_retouches=pinned_retouches,
        min_capacity=min_capacity)
    return (r - miss) / max(r, 1.0)


def sorted_scan_hit_rate_grid(
    policy: str,
    coverage: torch.Tensor,
    total_refs: torch.Tensor,
    distinct_pages: torch.Tensor,
    pinned_retouches: torch.Tensor,
    capacities: torch.Tensor,
    min_capacities: torch.Tensor,
) -> torch.Tensor:
    """Batched :func:`sorted_scan_hit_rate` for K sorted-stream candidates.

    The per-candidate dispatch (thrash / compulsory / frequency-aware)
    becomes branchless ``where`` selects so a whole knob grid solves in one
    pass.

    Args:
      coverage:       window-coverage histogram(s): (P,) when every
                      candidate shares ONE stream (the O(P log P) coverage
                      sort then runs once for the whole grid), or (K, P)
                      when index-backed candidates contribute distinct
                      streams.  Its device is the device of the solve.
      total_refs:     (K,) request volumes R.
      distinct_pages: (K,) distinct page counts N.
      pinned_retouches: (K,) pressure-pinned window-junction re-touch counts.
      capacities:     (K,) buffer capacities in pages.
      min_capacities: (K,) Theorem III.1 capacity premises.

    Returns:
      (K,) float32 hit rates.
    """
    dev = _tensor(coverage).device
    r = _tensor(total_refs, dev).float()
    n = _tensor(distinct_pages, dev).float()
    # Regime dispatch compares in exact integer arithmetic (float32 rounds
    # page counts above 2^24); float32 stays for the miss-count values.
    cap_i = _exact_caps(capacities, dev)
    n_i = _exact_caps(distinct_pages, dev)
    pinned = _tensor(pinned_retouches, dev).float()
    if policy in RECENCY_POLICIES:
        miss = n
    else:
        cov = _tensor(coverage, dev).float()
        if cov.ndim == 1:
            freq = _freq_misses_from_prefix(_desc_prefix(cov), r, n, cap_i,
                                            pinned)
        else:
            freq = _sorted_scan_misses_freq(cov, cap_i, pinned)
        miss = torch.where(cap_i >= n_i, n, freq)
    thrash = torch.minimum(torch.maximum(r - pinned, n), r)
    miss = torch.where(cap_i < _exact_caps(min_capacities, dev), thrash, miss)
    return torch.where(r > 0, (r - miss) / torch.clamp(r, min=1.0), 0.0)


def sorted_scan_miss_curve(
    policy: str,
    capacities,
    *,
    total_refs: float,
    distinct_pages: float,
    coverage: Optional[torch.Tensor] = None,
    pinned_retouches: float = 0.0,
    min_capacity: int = 1,
) -> torch.Tensor:
    """Misses of ONE sorted stream as a function of buffer capacity.

    Evaluates :func:`sorted_scan_misses` over a whole capacity vector in one
    batched solve (the stream statistics are shared, the coverage sort runs
    once).  The curve is non-increasing in capacity: thrash below the
    Theorem III.1 premise, then the policy-aware regime, floored at the
    compulsory count N.  Returns a (K,) miss vector aligned with
    ``capacities``, on the device of ``coverage`` (else of ``capacities``).
    """
    dev = coverage.device if isinstance(coverage, torch.Tensor) else None
    caps = _tensor(capacities, dev)   # integer dtypes keep exact compares
    caps_f = caps.float()
    r = float(total_refs)
    if r <= 0.0:
        return torch.zeros_like(caps_f)
    if policy not in RECENCY_POLICIES and coverage is not None:
        ones = torch.ones_like(caps_f)
        h = sorted_scan_hit_rate_grid(
            policy, _tensor(coverage).float(), r * ones,
            float(distinct_pages) * ones, float(pinned_retouches) * ones,
            caps, float(min_capacity) * ones)
        return (1.0 - h) * r
    # Recency policies (and coverage-less profiles) price through the
    # compulsory closed form; only the thrash edge depends on capacity.
    miss = torch.full_like(caps_f, float(distinct_pages))
    thrash = min(max(r - float(pinned_retouches), float(distinct_pages)), r)
    return torch.where(_exact_caps(caps) < int(min_capacity),
                       torch.full_like(caps_f, thrash), miss)


def hit_rate_curve(
    policy: str,
    counts: torch.Tensor,
    sample_refs: float,
    full_refs: float,
    capacities,
) -> torch.Tensor:
    """Hit rate of ONE request histogram across a capacity vector.

    The IRM counterpart of :func:`sorted_scan_miss_curve`: K capacities of
    the SAME page-reference histogram solve as one lockstep bisection
    through :func:`hit_rate_grid`.  Returns a (K,) hit-rate vector aligned
    with ``capacities``.
    """
    counts = _tensor(counts).float()
    caps = _tensor(capacities, counts.device)
    ones = torch.ones(caps.shape, dtype=torch.float32, device=counts.device)
    h, _ = hit_rate_grid(
        policy, counts.expand(caps.shape + counts.shape),
        float(sample_refs) * ones, float(full_refs) * ones, caps)
    return h


# ---------------------------------------------------------------------------
# Dispatcher
# ---------------------------------------------------------------------------

def hit_rate(
    policy: str,
    capacity,
    probs: torch.Tensor,
    *,
    total_requests: Optional[float] = None,
    distinct_pages: Optional[float] = None,
    sorted_workload: bool = False,
) -> torch.Tensor:
    """Paper §III-B/§III-C dispatcher.

    * sorted workloads → Theorem III.1 closed form (NOTE: only exact for
      recency policies; policy-aware callers should use the
      ``sorted_scan_*`` family, which adds the frequency-aware form),
    * ``C >= N``       → compulsory-miss closed form,
    * otherwise        → the policy-specific IRM estimator.
    """
    probs = _tensor(probs)
    n_distinct = (
        float(distinct_pages)
        if distinct_pages is not None
        else float(torch.sum(probs > 0))
    )
    if sorted_workload or (capacity is not None and float(capacity) >= n_distinct):
        if total_requests is None:
            raise ValueError("closed-form hit rate needs total_requests (R)")
        return hit_rate_compulsory(total_requests, n_distinct)
    if policy not in POLICIES:
        raise ValueError(f"unknown policy {policy!r}; expected one of {POLICIES}")
    if policy == "lfu":
        return hit_rate_lfu(probs, capacity)
    cap = torch.as_tensor(capacity, dtype=torch.float32)
    if policy == "lru":
        return hit_rate_lru(probs, cap)
    return hit_rate_fifo(probs, cap)


# ---------------------------------------------------------------------------
# Batched grid solver (CostSession.estimate_grid)
# ---------------------------------------------------------------------------

def hit_rate_grid(
    policy: str,
    counts: torch.Tensor,
    sample_refs: torch.Tensor,
    full_refs: torch.Tensor,
    capacities: torch.Tensor,
    sorted_coverage: Optional[torch.Tensor] = None,
    sorted_refs: Optional[torch.Tensor] = None,
    sorted_distinct: Optional[torch.Tensor] = None,
    sorted_pinned: Optional[torch.Tensor] = None,
    sorted_min_caps: Optional[torch.Tensor] = None,
    sorted_full_refs: Optional[torch.Tensor] = None,
    write_counts: Optional[torch.Tensor] = None,
    write_refs: Optional[torch.Tensor] = None,
    write_full_refs: Optional[torch.Tensor] = None,
):
    """Hit rates for K (histogram, capacity) candidates in one batched solve.

    The per-candidate dispatch of :func:`hit_rate` (compulsory closed form
    when ``C >= N``, zero when ``C < 1``, policy fixed point otherwise)
    becomes branchless ``where`` selects so the whole knob grid solves in
    one pass — K bisections run lockstep.  Everything runs on the device of
    ``counts``.

    When the ``sorted_*`` arguments are given (mixed workloads containing
    sorted probe streams), each candidate's IRM estimate is composed with the
    policy-aware sorted-scan model (:func:`sorted_scan_hit_rate_grid`) by
    expected-miss addition over a shared buffer.

    Args:
      counts:      (K, P) expected page-reference histograms (IRM parts).
      sample_refs: (K,) sample request mass (normalizer of Pr_req).
      full_refs:   (K,) full-workload request volume R (compulsory branch).
      capacities:  (K,) buffer capacities in pages (may be <= 0).
      sorted_coverage / sorted_refs / sorted_distinct / sorted_pinned /
      sorted_min_caps: per-candidate sorted-stream statistics, shapes as in
        :func:`sorted_scan_hit_rate_grid`.
      sorted_full_refs: (K,) full-workload sorted request volume.
      write_counts / write_refs / write_full_refs: per-candidate write-stream
        histograms ((K, P) or one shared (P,)), sample write mass and full
        write volume.  Write references are COMBINED into the request
        histogram before the solve, and the dirty-eviction writeback stream
        is subtracted from the hit rate (``h`` may be slightly negative at
        tiny capacities — by construction).

    Returns:
      (hit_rates (K,), distinct_pages (K,)) float32 — pages with nonzero
      mass in either the IRM histogram or the sorted coverage.
    """
    if policy not in POLICIES:
        raise ValueError(f"unknown policy {policy!r}; expected one of {POLICIES}")
    counts = _tensor(counts).float()
    dev = counts.device
    sample_refs = _tensor(sample_refs, dev).float()
    full_refs = _tensor(full_refs, dev).float()
    has_write = write_counts is not None
    if has_write:
        # writes fault their target page exactly like reads: fold the write
        # stream into the request histogram so misses price automatically,
        # then add the dirty-eviction flush stream below.
        write_counts = _tensor(write_counts, dev).float()
        counts = counts + write_counts
        sample_refs = sample_refs + _tensor(write_refs, dev).float()
        full_refs = full_refs + _tensor(write_full_refs, dev).float()
    probs = counts / torch.clamp(sample_refs[:, None], min=1e-30)
    n_distinct_i = torch.sum(counts > 0, dim=1)
    n_distinct = n_distinct_i.float()
    capacities = _tensor(capacities, dev)
    cap_f = capacities.float()
    # exact integer compares for the regime dispatch (float32 rounds page
    # counts above 2^24); the fixed-point solve itself stays float32 — it
    # only runs below n_distinct, far under the rounding threshold.
    cap_i = _exact_caps(capacities, dev)
    c_eff = torch.clamp(cap_f, min=1.0)
    if policy == "lru":
        h_policy = hit_rate_lru(probs, c_eff)
    elif policy == "fifo":
        h_policy = hit_rate_fifo(probs, c_eff)
    else:
        h_policy = hit_rate_lfu(probs, c_eff)
    floor = torch.zeros_like(h_policy)
    if has_write:
        wprobs = write_counts / torch.clamp(sample_refs[:, None], min=1e-30)
        h_policy = h_policy - _writeback_terms(policy, probs, wprobs, c_eff)
        floor = -torch.sum(wprobs, dim=1)  # cap < 1: every write flushes
    h_comp = hit_rate_compulsory(full_refs, n_distinct)
    h = torch.where(cap_i >= n_distinct_i, h_comp, h_policy)
    h = torch.where(cap_i < 1, floor, h)
    h = torch.where(sample_refs > 0, h, 0.0)
    if sorted_coverage is None:
        return h, n_distinct
    sorted_coverage = _tensor(sorted_coverage, dev).float()
    h_s = sorted_scan_hit_rate_grid(
        policy, sorted_coverage, sorted_refs, sorted_distinct, sorted_pinned,
        capacities, sorted_min_caps)
    s_full = _tensor(sorted_full_refs, dev).float()
    total_full = full_refs + s_full
    miss = (1.0 - h) * full_refs + (1.0 - h_s) * s_full
    h_mix = torch.where(total_full > 0,
                        1.0 - miss / torch.clamp(total_full, min=1.0), 0.0)
    n_mix = torch.sum((counts > 0) | (sorted_coverage > 0), dim=1).float()
    return h_mix, n_mix
