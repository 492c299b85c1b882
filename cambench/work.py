"""Least work of the port's CAM kernels, and the H100's peaks.

A kernel's roofline share is its least time over its device time, where
the least time is the larger of bytes / HBM bandwidth and operations /
float32 rate.  The counts are functions of a call's shapes and inputs
only, so the share reads the same work whatever implements the kernel:

* bytes: each input the call's mode reads, read once, and each output
  written once;
* operations: one pass of the closed form a cell needs over its row's
  pages (no solver iteration is counted) for every cell whose capacity
  lies in the fixed-point regime (``1 <= C < N``); a cell outside it is a
  closed form of two scalars.  ``profile_grid``: one add for every
  nonzero table entry a query spreads over the histogram.

Counting no iterations differs from the bounds of ``chip_smoke.py``
(``price_work`` multiplies by the solver's iteration count), which a
kernel that needs fewer iterations would read above 100% against.
"""
from __future__ import annotations

#: NVIDIA H100 SXM data sheet (dense): HBM3 bytes/s, float32 non-tensor FLOP/s.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

#: Device kernels of each wrapper, matched by substring of the kernel name.
KERNELS = {
    "price_grid": ("price_kernel", "init_best", "unpack_best"),
    "profile_grid": ("occupancy_kernel", "round_to_float"),
}

PRICE_ARGS = ("probs", "sorted_probs", "cov_desc", "f32s", "i32s", "caps_f",
              "caps_i", "ids", "wprobs", "wprobs_q")
PAD_ID = 2**31 - 1
_MODES = {"lru": 0, "fifo": 1, "lfu": 2}


def least_seconds(nbytes: float, ops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS_PER_S)


def _nbytes(t) -> int:
    return int(t.numel()) * int(t.element_size())


def price_call(args, kwargs) -> dict:
    """What the count needs of a ``price_grid(policy, *arrays,
    has_sorted=, has_write=, ...)`` call: its mode, the byte size of each
    array and the small per-cell arrays (nothing large is kept alive)."""
    call = dict(zip(("policy",) + PRICE_ARGS, args))
    call.update(kwargs)
    out = {"policy": call["policy"],
           "has_sorted": bool(call.get("has_sorted")),
           "has_write": bool(call.get("has_write", False)),
           "shape": tuple(call["probs"].shape),
           "nbytes": {n: _nbytes(call[n]) for n in PRICE_ARGS
                      if call.get(n) is not None}}
    for n in ("i32s", "caps_i", "ids"):
        out[n] = call[n]
    return out


def price_grid_work(call: dict):
    """(bytes, operations) of one ``price_grid`` call."""
    import torch

    policy = call["policy"]
    has_sorted, has_write = call["has_sorted"], call["has_write"]
    lfu_read = policy in ("lfu", "multi")
    used = ["probs", "f32s", "i32s", "caps_f", "caps_i", "ids"]
    if lfu_read:
        used.append("sorted_probs")
        if has_sorted:
            used.append("cov_desc")
    if has_write:
        used.append("wprobs")
        if lfu_read:
            used.append("wprobs_q")
    k, p = call["shape"]
    c = call["caps_i"].shape[1]
    nbytes = sum(call["nbytes"][n] for n in used) + 4 * k * c + 8
    caps = call["caps_i"].long()
    n_irm = call["i32s"][:, 0:1].long()
    if policy == "multi":
        pol = call["i32s"][:, 3:4].long().expand(k, c)
    else:
        pol = torch.full((k, c), _MODES[policy], device=caps.device)
    live = (call["ids"] != PAD_ID) & (caps >= 1) & (caps < n_irm)
    per_page = torch.where(pol == 0, 4, 6) + (10 if has_write else 0)
    recency = per_page * p
    top = torch.clamp(caps, max=p)
    lfu = top * (2 if has_write else 1) + (p if has_write else 0)
    if has_sorted:
        lfu = lfu + top
    ops = torch.where(pol == 2, lfu, recency)
    return float(nbytes), float(torch.where(live, ops, 0).sum())


def profile_grid_work(call: dict):
    """(bytes, operations) of one ``profile_grid(keys, pages, lut, bands,
    c_ipp=, pad=)`` call."""
    keys, lut = call["keys"], call["lut"]
    nbytes = sum(_nbytes(call[n]) for n in ("keys", "pages", "lut", "bands"))
    nbytes += keys.shape[0] * call["pad"] * 4
    nnz = (lut != 0).sum(dim=1)
    adds = float(nnz[keys[keys >= 0].long()].sum())
    return float(nbytes), adds


def profile_call(args, kwargs) -> dict:
    call = dict(zip(("keys", "pages", "lut", "bands"), args))
    call.update(kwargs)
    return call


WORK = {"price_grid": (price_call, price_grid_work),
        "profile_grid": (profile_call, profile_grid_work)}
