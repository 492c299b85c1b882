"""Flash decode: one query token of GQA attention over a static KV cache.

Replaces the Pallas kernel ``repro/kernels/decode_attention.py::
decode_attention``: q (B, 1, H, D) against caches (B, S, Hk, D), scores of
positions at or past ``lengths[b]`` filled with -1e30 before a float32
softmax, the output in q's type.  The caches may be bfloat16 under a
float32 query, as the serve path's default bfloat16 cache is for float32
models.

* :func:`repro_torch.kernels.ref.decode_attention_ref` is the plain PyTorch
  version (the CPU path and the card-side yardstick);
* :func:`decode_attention` is the wrapper: CPU tensors take the plain
  version, CUDA tensors launch ``csrc/decode_attention.cu`` or raise.
  The kernel is a split-cache flash-decode: one CTA per (cache split, KV
  head, batch) serving that head's H / Hk query heads with 16-byte cache
  loads, each split's (m, l, acc) written to float32 scratch and merged in
  split order by a second small launch (deterministic).
  :func:`decode_splits` picks the split count.  ``launches`` counts
  wrapper calls that launched the kernel (one per call).

What bounds it on the H100: the bytes of the valid cache rows, each read
once; decode attention does ~1 operation per byte, far below the card's
ridge point, so the splits are there to put enough CTAs and bytes in
flight to fill the card.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import (check_aligned, refuse_dtensor,
                                        refuse_grad)
from repro_torch.kernels.ref import decode_attention_ref

__all__ = ["decode_attention", "decode_attention_ref", "decode_splits",
           "launches"]

#: Kernel launches (not plain-version calls) since import.
launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: (query, cache) dtype pairs the kernel takes.
_PAIRS = {(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
          (torch.float32, torch.bfloat16)}
_HEAD_DIMS = (32, 64, 80, 128)
_MAX_GROUP = 16
#: The split chooser's targets: CTAs an SM (the split kernel's registers,
#: ~160 a thread at 128 threads, leave room for 3), fewest positions a
#: split, and most splits (the combine keeps two floats a split in shared
#: memory).
CTAS_PER_SM = 3
MIN_SPLIT = 64
MAX_SPLITS = 512


def decode_splits(batch: int, kv_heads: int, seq: int,
                  sms: int) -> tuple[int, int]:
    """``(n_splits, split_len)`` for a cache of ``seq`` positions: enough
    splits that ``batch * kv_heads * n_splits`` CTAs give each of ``sms``
    SMs about ``CTAS_PER_SM``, none shorter than ``MIN_SPLIT`` positions
    (one split covers a shorter cache).  Split i covers positions
    ``[i * split_len, (i + 1) * split_len)``; the last one also takes the
    remainder."""
    units = max(1, batch * kv_heads)
    n = min(CTAS_PER_SM * sms // units, seq // MIN_SPLIT, MAX_SPLITS)
    n = max(1, n)
    return n, max(1, seq // n)


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def decode_attention(q, k_cache, v_cache, lengths):
    """q: (B,1,H,D); caches: (B,S,Hk,D); lengths: (B,). Returns (B,1,H,D).
    Forward only: inputs that require grad under grad mode raise."""
    b, one, h, d = q.shape
    if one != 1 or k_cache.dim() != 4 or v_cache.shape != k_cache.shape \
            or k_cache.shape[0] != b or k_cache.shape[3] != d \
            or h % k_cache.shape[2] or tuple(lengths.shape) != (b,):
        raise ValueError(
            f"decode_attention: q (B,1,H,D), caches (B,S,Hk,D) with H a "
            f"multiple of Hk and lengths (B,) expected, got {tuple(q.shape)},"
            f" {tuple(k_cache.shape)}, {tuple(v_cache.shape)}, "
            f"{tuple(lengths.shape)}")
    refuse_dtensor("decode_attention", q, k_cache, v_cache, lengths)
    refuse_grad("decode_attention", q, k_cache, v_cache)
    if q.device.type == "cpu":
        return decode_attention_ref(q, k_cache, v_cache, lengths)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention runs on CPU or CUDA tensors, got "
                         f"{q.device}")
    return _launch(q, k_cache, v_cache, lengths)


def _launch(q, k, v, lengths):
    global launches
    b, _, h, d = q.shape
    s, hk = k.shape[1], k.shape[2]
    if k.device != q.device or v.device != q.device or v.dtype != k.dtype:
        raise ValueError(f"decode_attention: caches {k.dtype}/{v.dtype} on "
                         f"{k.device}/{v.device}, q on {q.device}")
    if (q.dtype, k.dtype) not in _PAIRS:
        raise ValueError(f"decode_attention kernel takes float32/float32, "
                         f"bfloat16/bfloat16 or a float32 query over a "
                         f"bfloat16 cache, got q {q.dtype}, caches "
                         f"{k.dtype}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"decode_attention kernel takes head_dim in "
                         f"{_HEAD_DIMS}, got {d}")
    if h // hk > _MAX_GROUP:
        raise ValueError(f"decode_attention kernel serves at most "
                         f"{_MAX_GROUP} query heads per KV head, got {h // hk}")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("decode_attention kernel needs the head dim "
                         "contiguous (stride 1)")
    if lengths.device != q.device:
        raise ValueError(f"decode_attention: lengths on {lengths.device}, q "
                         f"on {q.device}")
    check_aligned("decode_attention", "k_cache", k)
    check_aligned("decode_attention", "v_cache", v)
    lens = lengths.to(torch.int32).contiguous()
    out = torch.empty((b, 1, h, d), dtype=q.dtype, device=q.device)
    index = q.device.index
    if index is None:
        index = torch.cuda.current_device()
    n_splits, split_len = decode_splits(b, hk, s, _sm_count(index))
    part = None
    if n_splits > 1:   # per split: acc (g, D) and (m, l) (g, 2)
        part = torch.empty(b * hk * n_splits * (h // hk) * (d + 2),
                           dtype=torch.float32, device=q.device)
    lib = _build.library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = lib.decode_attention_launch(
            _DTYPES[q.dtype], _DTYPES[k.dtype], d, b, s, h, hk, n_splits,
            split_len, q.data_ptr(), q.stride(0), q.stride(2),
            k.data_ptr(), k.stride(0), k.stride(1), k.stride(2),
            v.data_ptr(), v.stride(0), v.stride(1), v.stride(2),
            lens.data_ptr(), out.data_ptr(),
            None if part is None else part.data_ptr(), stream)
    _build.check(code, "decode_attention")
    launches += 1
    return out
