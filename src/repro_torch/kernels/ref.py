"""Plain PyTorch oracles of the attention and Che kernels.

Mirrors ``repro/kernels/ref.py``: each function computes what its kernel
computes, in float32, from whole tensors.  The kernel wrappers run these on
CPU tensors, and the tests and ``chip_smoke.py`` hold the CUDA kernels
against them.
"""
from __future__ import annotations

import math

import torch

__all__ = ["flash_attention_ref", "decode_attention_ref",
           "decode_attention_split_ref", "che_sums_ref"]


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


def decode_attention_split_ref(q, k_cache, v_cache, lengths, n_splits: int,
                               split_len: int):
    """``decode_attention_ref`` computed as the split-cache kernel does it:
    per split (positions ``[i * split_len, (i + 1) * split_len)``, the last
    split to S) a float32 ``(m, l, acc)``, then a merge in split order.
    Splits wholly past ``min(lengths[b], S)`` (all of S when the length is
    <= 0) contribute nothing.  The algebra's oracle for the tests; nothing
    on the main path calls it."""
    b, _, h, d = q.shape
    s, hk = k_cache.shape[1], k_cache.shape[2]
    g = h // hk
    qg = q.reshape(b, hk, g, d).float()
    kf, vf = k_cache.float(), v_cache.float()
    out = torch.zeros((b, hk, g, d), dtype=torch.float32, device=q.device)
    for bi in range(b):
        length = int(lengths[bi])
        end = min(length, s) if length > 0 else s
        parts = []
        for i in range(n_splits):
            lo = i * split_len
            hi = min(s if i == n_splits - 1 else lo + split_len, end)
            if lo >= hi:
                continue
            sc = torch.einsum("kgd,tkd->kgt", qg[bi],
                              kf[bi, lo:hi]) / math.sqrt(d)
            if length <= 0:
                sc = torch.full_like(sc, -1e30)
            m = sc.amax(dim=-1)
            p = torch.exp(sc - m[..., None])
            parts.append((m, p.sum(-1), torch.einsum("kgt,tkd->kgd", p,
                                                     vf[bi, lo:hi])))
        if not parts:
            continue
        m_all = torch.stack([m for m, _, _ in parts]).amax(0)
        num = torch.zeros((hk, g, d), dtype=torch.float32, device=q.device)
        den = torch.zeros((hk, g), dtype=torch.float32, device=q.device)
        for m, l, acc in parts:          # fixed order: split 0, 1, ...
            w = torch.exp(m - m_all)
            num = num + w[..., None] * acc
            den = den + w * l
        out[bi] = num / den[..., None]
    return out.reshape(b, 1, h, d).to(q.dtype)


def che_sums_ref(probs, t_candidates):
    """sum_i (1 - exp(-p_i * t_k)) for each candidate k. (K,) f32."""
    p = probs.float()[None, :]
    t = t_candidates.float()[:, None]
    return torch.sum(-torch.expm1(-p * t), dim=1)
