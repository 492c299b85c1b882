"""Plain PyTorch oracles of the attention and Che kernels.

Mirrors ``repro/kernels/ref.py``: each function computes what its kernel
computes, in float32, from whole tensors.  The kernel wrappers run these on
CPU tensors, and the tests and ``chip_smoke.py`` hold the CUDA kernels
against them.
"""
from __future__ import annotations

import math

import torch

__all__ = ["flash_attention_ref", "decode_attention_ref", "che_sums_ref"]


def flash_attention_ref(q, k, v, *, causal: bool = True):
    """q: (B,Sq,H,D); k/v: (B,Skv,Hk,D) with H % Hk == 0. f32 softmax."""
    b, sq, h, d = q.shape
    hk = k.shape[2]
    g = h // hk
    qg = q.reshape(b, sq, hk, g, d).float()
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) / math.sqrt(d)
    if causal:
        mask = (torch.arange(sq, device=q.device)[:, None]
                >= torch.arange(k.shape[1], device=q.device)[None, :])
        scores = torch.where(mask, scores, -1e30)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", p, v.float())
    return out.reshape(b, sq, h, d).to(q.dtype)


def decode_attention_ref(q, k_cache, v_cache, lengths):
    """q: (B,1,H,D); caches: (B,S,Hk,D); lengths: (B,)."""
    b, _, h, d = q.shape
    hk = k_cache.shape[2]
    g = h // hk
    qg = q.reshape(b, 1, hk, g, d)[:, 0].float()
    scores = torch.einsum("bkgd,btkd->bkgt", qg,
                          k_cache.float()) / math.sqrt(d)
    mask = (torch.arange(k_cache.shape[1], device=q.device)[None]
            < lengths[:, None])
    scores = torch.where(mask[:, None, None], scores, -1e30)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", p, v_cache.float())
    return out.reshape(b, 1, h, d).to(q.dtype)


def che_sums_ref(probs, t_candidates):
    """sum_i (1 - exp(-p_i * t_k)) for each candidate k. (K,) f32."""
    p = probs.float()[None, :]
    t = t_candidates.float()[:, None]
    return torch.sum(-torch.expm1(-p * t), dim=1)
