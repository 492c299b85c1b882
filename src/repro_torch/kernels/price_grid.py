"""Fused PriceTable solve: policy fixed point + sorted/mixed composition +
objective argmin in ONE launch (the DeviceExecutor hot path).

Replaces the Pallas kernel ``repro/kernels/price_grid.py::price_grid``
(body ``_price_kernel``).  A (K rows x C cells-per-row) padded table prices
against each row's resident request probabilities: the Che/Fricker
bisection (or the LFU top-C mass), the dirty-eviction writeback at the same
characteristic time, the policy-aware sorted-scan model and the mixed
composition of ``cache_models.hit_rate_grid``, then the objective
``(1 - h) * scale`` and its global argmin (lowest cell id on ties).

* :func:`price_grid_ref` is the plain PyTorch version of the same function
  (the CPU path and the card-side yardstick);
* :func:`price_grid` is the wrapper: CPU tensors take the plain version,
  CUDA tensors launch the hand-written kernel ``csrc/price_grid.cu`` (one
  thread-block cluster per row, the row's slices resident in the CTAs'
  shared memory, all of its cells bisecting in lockstep with one
  cross-CTA reduction a step, stopping once every cell has converged; a
  packed 64-bit ``atomicMin`` for the argmin) or raise.  ``launches``
  counts kernel launches.

What bounds the kernel on the H100: ``expm1f``/divide work over each row's
P pages for every live cell and bisection step, read from shared memory,
not the bytes of its inputs (read once).

Semantics mirror ``cache_models.hit_rate_grid`` branch for branch
(compulsory closed form where ``cap >= N`` in exact int32 compares, zero
below one page, thrash/frequency/compulsory sorted regimes, expected-miss
composition); equivalence with the host executor is float32 summation
order only.
"""
from __future__ import annotations

import torch

__all__ = ["price_grid", "price_grid_ref", "PAD_ID", "launches"]

#: Cell id marking a padded (row, slot) cell; valid ids are always below it.
PAD_ID = 2**31 - 1

_F32_COLS = 16   # packed per-row float32 scalars (see price_grid_ref)
_I32_COLS = 8    # packed per-row int32 scalars

_MODES = {"lru": 0, "fifo": 1, "lfu": 2, "multi": 3}

#: Kernel launches (not plain-version calls) since import.
launches = 0


def price_grid_ref(policy: str, probs, sorted_probs, cov_desc, f32s, i32s,
                   caps_f, caps_i, ids, wprobs=None, wprobs_q=None, *,
                   has_sorted: bool, has_write: bool = False,
                   iters: int = 64):
    """Plain PyTorch version of :func:`price_grid` (same arguments).

    All (row, cell) pairs solve at once as (K, C, P) tensor work; ``policy
    == "multi"`` selects per row by the policy id in i32 column 3.

    Packed scalar columns (one row each):
      f32: 0 sample_refs, 1 full_refs, 2 n_distinct, 3 pmin,
           4 sorted_refs, 5 sorted_full_refs, 6 sorted_distinct,
           7 sorted_pinned, 8 objective_scale
      i32: 0 n_distinct, 1 sorted_distinct, 2 sorted_min_capacity,
           3 policy id (read iff policy == "multi")
    """
    if policy not in _MODES:
        raise ValueError(f"unknown price_grid policy {policy!r}")
    if has_write and wprobs is None:
        raise ValueError("has_write=True needs wprobs (and wprobs_q for "
                         "lfu/multi launches)")
    dev = probs.device
    f, z = f32s, i32s
    sample_refs, full, n_f, pmin = f[:, 0:1], f[:, 1:2], f[:, 2:3], f[:, 3:4]
    n_i = z[:, 0:1]
    pol = (z[:, 3:4] if policy == "multi"
           else torch.full_like(n_i, _MODES[policy]))
    c_eff = torch.clamp(caps_f, min=1.0)                    # (K, C)
    pp = probs[:, None, :]                                  # (K, 1, P)
    lfu_read = policy in ("lfu", "multi")
    w_mass = wprobs.sum(dim=1, keepdim=True) if has_write else None

    def occ(t):                                             # (K, C) -> (K, C, P)
        pt = pp * t[..., None]
        che = -torch.expm1(-pt)
        if policy == "lru":
            return che
        fifo = pt / (1.0 - pp + pt)
        if policy == "fifo":
            return fifo
        return torch.where(pol[..., None] == 0, che, fifo)

    h_pol = wb = None
    if policy in ("lru", "fifo", "multi"):
        hi = torch.clamp(4.0 * c_eff / pmin, min=1.0)
        lo = torch.zeros_like(hi)
        for _ in range(iters):
            mid = 0.5 * (lo + hi)
            below = occ(mid).sum(dim=-1) - c_eff < 0.0
            lo = torch.where(below, mid, lo)
            hi = torch.where(below, hi, mid)
        t_c = 0.5 * (lo + hi)
        o = occ(t_c)
        h_pol = (pp * o).sum(dim=-1)
        if has_write:
            w = wprobs[:, None, :]
            r = torch.clamp(pp - w, min=0.0)
            dirty = w + r * -torch.expm1(-w * t_c[..., None])
            wb = ((1.0 - o) * dirty).sum(dim=-1)
    iota = torch.arange(probs.shape[1], device=dev)
    if lfu_read:                                            # lfu: top-C mass
        mask = iota < torch.clamp(caps_i, min=1)[..., None]  # (K, C, P)
        h_lfu = torch.where(mask, sorted_probs[:, None, :], 0.0).sum(dim=-1)
        h_pol = h_lfu if policy == "lfu" else torch.where(pol == 2, h_lfu,
                                                          h_pol)
        if has_write:
            kept = torch.where(mask, wprobs_q[:, None, :], 0.0).sum(dim=-1)
            wb_lfu = w_mass - kept
            wb = wb_lfu if policy == "lfu" else torch.where(pol == 2, wb_lfu,
                                                            wb)
    floor = torch.zeros_like(h_pol)
    if has_write:
        h_pol = h_pol - wb
        floor = (-w_mass).expand_as(h_pol)  # cap < 1: every write flushes

    h_comp = torch.where(full > 0, (full - n_f) / torch.clamp(full, min=1.0),
                         0.0)
    h = torch.where(caps_i >= n_i, h_comp, h_pol)
    h = torch.where(caps_i < 1, floor, h)
    h = torch.where(sample_refs > 0, h, 0.0)

    if has_sorted:
        s_r, s_full, s_n, pinned = f[:, 4:5], f[:, 5:6], f[:, 6:7], f[:, 7:8]
        s_n_i, s_min_i = z[:, 1:2], z[:, 2:3]
        miss = s_n.expand_as(h)
        if lfu_read:
            cmask = iota < caps_i[..., None]
            topc = torch.where(cmask, cov_desc[:, None, :], 0.0).sum(dim=-1)
            freq = torch.minimum(torch.maximum(
                torch.minimum(s_r - topc, s_r - pinned), s_n), s_r)
            freq = torch.where(caps_i >= s_n_i, s_n, freq)
            miss = freq if policy == "lfu" else torch.where(pol == 2, freq,
                                                            miss)
        thrash = torch.minimum(torch.maximum(s_r - pinned, s_n), s_r)
        miss = torch.where(caps_i < s_min_i, thrash, miss)
        h_s = torch.where(s_r > 0, (s_r - miss) / torch.clamp(s_r, min=1.0),
                          0.0)
        total = full + s_full
        miss_mix = (1.0 - h) * full + (1.0 - h_s) * s_full
        h = torch.where(total > 0,
                        1.0 - miss_mix / torch.clamp(total, min=1.0), 0.0)

    inf = torch.tensor(float("inf"), device=dev)
    obj = torch.where(ids < PAD_ID, (1.0 - h) * f[:, 8:9], inf)
    best_val = obj.min()
    pad = torch.tensor(PAD_ID, dtype=torch.int32, device=dev)
    best_id = torch.where(obj == best_val, ids, pad).min()
    return (h, best_val.reshape(1, 1).float(),
            best_id.reshape(1, 1).to(torch.int32))


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch(policy, probs, sorted_probs, cov_desc, f32s, i32s, caps_f,
            caps_i, ids, wprobs, wprobs_q, has_sorted, has_write, iters,
            steps):
    global launches
    from repro_torch.kernels import _build

    lfu_read = policy in ("lfu", "multi")
    k, p_width = probs.shape
    c = caps_f.shape[1]
    needs = {"probs": (probs, torch.float32, (k, p_width)),
             "f32s": (f32s, torch.float32, (k, _F32_COLS)),
             "i32s": (i32s, torch.int32, (k, _I32_COLS)),
             "caps_f": (caps_f, torch.float32, (k, c)),
             "caps_i": (caps_i, torch.int32, (k, c)),
             "ids": (ids, torch.int32, (k, c))}
    if lfu_read:
        needs["sorted_probs"] = (sorted_probs, torch.float32, (k, p_width))
        if has_sorted:
            needs["cov_desc"] = (cov_desc, torch.float32, (k, p_width))
    if has_write:
        needs["wprobs"] = (wprobs, torch.float32, (k, p_width))
        if lfu_read:
            needs["wprobs_q"] = (wprobs_q, torch.float32, (k, p_width))
    if steps is not None:
        needs["steps"] = (steps, torch.int32, (k, c))
    for name, (t, dtype, shape) in needs.items():
        if t is None or t.device != probs.device or t.dtype != dtype \
                or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"price_grid: {name} must be a contiguous {dtype} tensor of "
                f"shape {shape} on {probs.device}, got "
                + ("None" if t is None else
                   f"{t.dtype} {tuple(t.shape)} on {t.device}"))
    used = {n: t for n, (t, _, _) in needs.items()}
    dev = probs.device
    h = torch.empty((k, c), dtype=torch.float32, device=dev)
    best_key = torch.empty((1,), dtype=torch.int64, device=dev)
    best_val = torch.empty((1, 1), dtype=torch.float32, device=dev)
    best_id = torch.empty((1, 1), dtype=torch.int32, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.price_grid_launch(
            _MODES[policy], int(has_sorted), int(has_write), int(iters),
            k, p_width, c, probs.data_ptr(), _ptr(used.get("sorted_probs")),
            _ptr(used.get("cov_desc")), _ptr(used.get("wprobs")),
            _ptr(used.get("wprobs_q")), f32s.data_ptr(), i32s.data_ptr(),
            caps_f.data_ptr(), caps_i.data_ptr(), ids.data_ptr(),
            h.data_ptr(), best_key.data_ptr(), best_val.data_ptr(),
            best_id.data_ptr(), _ptr(steps), stream)
    _build.check(code, "price_grid")
    launches += 1
    return h, best_val, best_id


def price_grid(policy: str, probs, sorted_probs, cov_desc, f32s, i32s,
               caps_f, caps_i, ids, wprobs=None, wprobs_q=None, *,
               has_sorted: bool, has_write: bool = False, iters: int = 64,
               steps=None):
    """Price a (K rows x C cells-per-row) padded table in one launch.

    Args:
      policy: a ``cache_models.POLICIES`` name (uniform launch) or
        ``"multi"`` — each row reads its own policy id from i32 column 3,
        so one launch prices lru/fifo/lfu rows side by side.
      probs: (K, P) float32 request probabilities per profile row —
        COMBINED read+write stream when ``has_write``.
      sorted_probs: (K, P) descending-sorted ``probs`` (read iff lfu or
        multi).
      cov_desc: (K, P) descending-sorted sorted-scan coverage (read iff
        (lfu or multi) AND ``has_sorted``).
      f32s / i32s: (K, 16) / (K, 8) packed per-row scalars (layout in
        :func:`price_grid_ref`).
      caps_f / caps_i / ids: (K, C) per-cell capacities (float32 / exact
        int32) and global cell ids; padded cells carry ``caps_i = -1`` and
        ``ids = PAD_ID``.
      wprobs: (K, P) write-reference probabilities under the SAME combined
        normalizer (read iff ``has_write``).
      wprobs_q: (K, P) ``wprobs`` permuted by descending combined ``probs``
        (read iff ``has_write`` and lfu or multi).
      iters: the most bisection steps a cell runs.
      steps: optional (K, C) int32 CUDA tensor the kernel fills with the
        bisection steps each cell ran (0 where a cell does not bisect) — a
        reading of the kernel; the plain version has none.

    Returns:
      (h (K, C) float32, best_val (1, 1) float32, best_id (1, 1) int32) —
      ``best_id`` is the global objective argmin over valid cells (lowest
      id on ties); ``PAD_ID`` with ``best_val = inf`` when no cell is valid.
      CPU tensors take :func:`price_grid_ref`; CUDA tensors launch the
      kernel.
    """
    if policy not in _MODES:
        raise ValueError(f"unknown price_grid policy {policy!r}")
    if has_write and wprobs is None:
        raise ValueError("has_write=True needs wprobs (and wprobs_q for "
                         "lfu/multi launches)")
    if probs.device.type == "cpu":
        if steps is not None:
            raise ValueError("price_grid: steps is a reading of the CUDA "
                             "kernel; the plain version runs every step")
        return price_grid_ref(policy, probs, sorted_probs, cov_desc, f32s,
                              i32s, caps_f, caps_i, ids, wprobs, wprobs_q,
                              has_sorted=has_sorted, has_write=has_write,
                              iters=iters)
    if probs.device.type != "cuda":
        raise ValueError(f"price_grid runs on CPU or CUDA tensors, got "
                         f"{probs.device}")
    return _launch(policy, probs, sorted_probs, cov_desc, f32s, i32s, caps_f,
                   caps_i, ids, wprobs, wprobs_q, has_sorted, has_write,
                   iters, steps)
