"""Unified model API: family dispatch for the training loss, prefill and
decode, the prefill variants of the recurrent families (last logits +
running state), and the input and decode-cache shapes.

Mirrors ``repro/models/model.py``; shapes come back as ``meta`` tensors
where JAX returns ``ShapeDtypeStruct``s.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.distributed.sharding import ShardingCtx
from repro_torch.models import layers, mamba2, rwkv, transformer

__all__ = ["loss_fn", "prefill_fn", "decode_fn", "rwkv_prefill", "hybrid_prefill",
           "input_specs", "input_dims", "cache_specs", "cache_dims"]


# ---------------------------------------------------------------------------
# Forward dispatch
# ---------------------------------------------------------------------------

def loss_fn(params, cfg: ModelConfig, batch, ctx: ShardingCtx):
    """Scalar float32 training loss of ``batch`` (tokens (B, S+1)).

    Each entry point runs under ``ctx.scope()``: under a mesh, the tensors
    the model makes itself meet the DTensor params as replicated ones (a
    caller that differentiates the loss runs its backward in that scope
    too)."""
    with ctx.scope():
        if cfg.family == "rwkv":
            return rwkv.rwkv_loss(params, cfg, batch, ctx)
        if cfg.family == "hybrid":
            return mamba2.hybrid_loss(params, cfg, batch, ctx)
        return transformer.transformer_loss(params, cfg, batch, ctx)


def prefill_fn(params, cfg: ModelConfig, batch, ctx: ShardingCtx):
    with ctx.scope():
        if cfg.family == "rwkv":
            return rwkv_prefill(params, cfg, batch, ctx)
        if cfg.family == "hybrid":
            return hybrid_prefill(params, cfg, batch, ctx)
        return transformer.transformer_prefill(params, cfg, batch, ctx)


def decode_fn(params, cfg: ModelConfig, batch, cache, ctx: ShardingCtx):
    with ctx.scope():
        if cfg.family == "rwkv":
            return rwkv.rwkv_decode(params, cfg, batch, cache, ctx)
        if cfg.family == "hybrid":
            return mamba2.hybrid_decode(params, cfg, batch, cache, ctx)
        return transformer.transformer_decode(params, cfg, batch, cache, ctx)


# ---------------------------------------------------------------------------
# Prefill variants for the recurrent families (last logits + running state)
# ---------------------------------------------------------------------------

def _last_logits(params, cfg, h):
    h = layers.rms_norm(h, params["final_ln"], cfg.norm_eps)
    return layers.matmul_f32(h[:, -1], params["lm_head"])


def rwkv_prefill(params, cfg, batch, ctx):
    h = rwkv.rwkv_embed(params, cfg, batch["tokens"], ctx)
    tm, cm, att = [], [], []
    for l in range(cfg.num_layers):
        blk = {k: v[l] for k, v in params["blocks"].items()}
        h, (tm_l, cm_l, att_l) = rwkv.rwkv_block(h, blk, cfg, ctx)
        tm.append(tm_l)
        cm.append(cm_l)
        att.append(att_l)
    return _last_logits(params, cfg, h), {
        "att": torch.stack(att), "tm": torch.stack(tm), "cm": torch.stack(cm)}


def hybrid_prefill(params, cfg, batch, ctx):
    tokens = batch["tokens"]
    b, t = tokens.shape
    h = layers.take_embedding(params["embed"], tokens, ctx)
    h = h.to(torch.bfloat16 if cfg.dtype == "bfloat16" else h.dtype)
    positions = torch.arange(t, dtype=torch.int32,
                             device=tokens.device)[None].expand(b, t)
    shared_block = transformer.make_block_fn(cfg, ctx, positions,
                                             return_kv=True)
    groups, k_inner = params["mamba"]["ln"].shape[:2]
    conv, ssm, kc, vc = [], [], [], []
    for gi in range(groups):
        conv_g, ssm_g = [], []
        for ki in range(k_inner):
            blk = {n: v[gi, ki] for n, v in params["mamba"].items()}
            h, (cs, ss) = mamba2.mamba2_block(h, blk, cfg, ctx)
            conv_g.append(cs)
            ssm_g.append(ss)
        conv.append(torch.stack(conv_g))
        ssm.append(torch.stack(ssm_g))
        (h, _), (k, v) = shared_block((h, 0.0), params["shared"])
        kc.append(k)
        vc.append(v)
    return _last_logits(params, cfg, h), {
        "conv": torch.stack(conv), "ssm": torch.stack(ssm),
        "k": torch.stack(kc), "v": torch.stack(vc)}


# ---------------------------------------------------------------------------
# Input / cache specs (meta tensors + logical dims) per (cfg, shape)
# ---------------------------------------------------------------------------

def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, torch.Tensor]:
    b, s = shape.global_batch, shape.seq_len
    tok = torch.int32
    if shape.kind in ("train", "prefill"):
        n = s + 1 if shape.kind == "train" else s
        toks = (b, n, cfg.num_codebooks) if cfg.family == "audio" else (b, n)
        batch = {"tokens": _meta(toks, tok)}
        if cfg.family == "vlm":
            batch["vision_embeds"] = _meta(
                (b, cfg.num_vision_tokens, cfg.vision_patch_dim),
                torch.float32)
            batch["positions_3d"] = _meta((3, b, s), tok)
        return batch
    # decode: one new token against a seq_len-deep context
    toks = (b, 1, cfg.num_codebooks) if cfg.family == "audio" else (b, 1)
    return {"tokens": _meta(toks, tok), "lengths": _meta((b,), tok)}


def input_dims(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, Tuple]:
    """Logical sharding roles matching input_specs."""
    dims: Dict[str, Tuple] = {}
    if cfg.family == "audio":
        dims["tokens"] = ("batch", None, None)
    else:
        dims["tokens"] = ("batch", None)
    if shape.kind != "decode" and cfg.family == "vlm":
        dims["vision_embeds"] = ("batch", None, None)
        dims["positions_3d"] = (None, "batch", None)
    if shape.kind == "decode":
        dims["lengths"] = ("batch",)
    return dims


def cache_specs(cfg: ModelConfig, shape: ShapeSpec,
                kv_dtype=torch.bfloat16) -> Optional[Dict[str, Any]]:
    """The decode cache of ``shape`` as ``meta`` tensors (None otherwise)."""
    if shape.kind != "decode":
        return None
    b, s = shape.global_batch, shape.seq_len
    if cfg.family == "rwkv":
        return rwkv.init_rwkv_state(cfg, b)
    if cfg.family == "hybrid":
        return mamba2.init_hybrid_state(cfg, b, s)
    return transformer.init_kv_cache(cfg, b, s, kv_dtype)


def cache_dims(cfg: ModelConfig) -> Dict[str, Tuple]:
    if cfg.family == "rwkv":
        return {"att": (None, "kv_batch", "heads", None, None),
                "tm": (None, "kv_batch", None),
                "cm": (None, "kv_batch", None)}
    if cfg.family == "hybrid":
        return {"conv": (None, None, "kv_batch", None, "heads"),
                "ssm": (None, None, "kv_batch", "heads", None, None),
                "k": (None, "kv_batch", "kv_seq", None, None),
                "v": (None, "kv_batch", "kv_seq", None, None)}
    return {"k": (None, "kv_batch", "kv_seq", None, None),
            "v": (None, "kv_batch", "kv_seq", None, None),
            "k_scale": (None, "kv_batch", "kv_seq", None),
            "v_scale": (None, "kv_batch", "kv_seq", None)}
