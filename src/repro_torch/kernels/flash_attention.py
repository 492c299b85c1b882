"""Flash attention (forward): blockwise streaming softmax with GQA.

Replaces the Pallas kernel ``repro/kernels/flash_attention.py::
flash_attention``: causal or non-causal attention of q (B, Sq, H, D) over
k / v (B, Skv, Hk, D), query head h reading KV head ``h // (H / Hk)``, a
float32 softmax and the output in q's type.

* :func:`repro_torch.kernels.ref.flash_attention_ref` is the plain PyTorch
  version (the CPU path and the card-side yardstick);
* :func:`flash_attention` is the wrapper: CPU tensors take the plain
  version, CUDA tensors launch ``csrc/flash_attention.cu`` (one CTA per
  (query tile, batch, head), K/V tiles streamed through shared memory with
  an online softmax, the (B, S, H, D) layout read through strides) or
  raise.  ``launches`` counts kernel launches.

What bounds it on the H100: 4·B·H·Sq·Skv·D operations (half when causal)
against the bf16 tensor-core rate.  bfloat16 inputs run FlashAttention-2
on the tensor cores (``mma.sync`` for both products, K/V tiles fed by
``cp.async``), which needs 16-byte-aligned bases and strides; a view that
breaks that raises.  float32 inputs keep the CUDA-core kernel: TF32 would
break the 1e-4 float32 parity.

As in the TPU kernel, causal attention counts query and key positions
from 0, so it takes Sq == Skv only.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import (check_aligned, refuse_dtensor,
                                        refuse_grad)
from repro_torch.kernels.ref import flash_attention_ref

__all__ = ["flash_attention", "flash_attention_ref", "launches"]

#: Kernel launches (not plain-version calls) since import.
launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 80, 128)


def _check(q, k, v, causal: bool) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: q (B,Sq,H,D) and k/v (B,Skv,Hk,D)"
                         f" expected, got {tuple(q.shape)}, {tuple(k.shape)},"
                         f" {tuple(v.shape)}")
    b, sq, h, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or h % k.shape[2]:
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)} do not fit "
                         f"q {tuple(q.shape)} (H must be a multiple of Hk)")
    if causal and k.shape[1] != sq:
        raise ValueError("flash_attention: causal attention takes Sq == Skv "
                         f"(q_offset 0), got Sq={sq}, Skv={k.shape[1]}")


def flash_attention(q, k, v, *, causal: bool = True):
    """q: (B,Sq,H,D); k/v: (B,Skv,Hk,D). Returns (B,Sq,H,D) in q's type.
    Forward only: inputs that require grad under grad mode raise."""
    _check(q, k, v, causal)
    refuse_dtensor("flash_attention", q, k, v)
    refuse_grad("flash_attention", q, k, v)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CPU or CUDA tensors, got "
                         f"{q.device}")
    return _launch(q, k, v, causal)


def _launch(q, k, v, causal: bool):
    global launches
    b, sq, h, d = q.shape
    skv, hk = k.shape[1], k.shape[2]
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"flash_attention: {name} is {t.dtype} on "
                             f"{t.device}, q is {q.dtype} on {q.device}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash_attention kernel takes float32 or bfloat16, "
                         f"got {q.dtype}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head_dim in "
                         f"{_HEAD_DIMS}, got {d}")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("flash_attention kernel needs the head dim "
                         "contiguous (stride 1)")
    if q.dtype == torch.bfloat16:
        for name, t in (("q", q), ("k", k), ("v", v)):
            check_aligned("flash_attention", name, t)
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lib = _build.library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = lib.flash_attention_launch(
            _DTYPES[q.dtype], d, int(causal), b, sq, skv, h, hk,
            q.data_ptr(), q.stride(0), q.stride(1), q.stride(2),
            k.data_ptr(), k.stride(0), k.stride(1), k.stride(2),
            v.data_ptr(), v.stride(0), v.stride(1), v.stride(2),
            out.data_ptr(), stream)
    _build.check(code, "flash_attention")
    launches += 1
    return out
