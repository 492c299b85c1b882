"""Decoder-only transformer forward passes for the dense family.

Mirrors ``repro/models/transformer.py`` for inference: embedding, the block
function, full-sequence logits, prefill (last-token logits + per-layer KV)
and one decode step against a static KV cache.  Depth is a Python loop over
views of the layer-stacked ``(L, ...)`` tensors where JAX scans; there is
no remat on this inference-only path.  The decode step writes the new
token's K/V into the cache in place (JAX returns a new cache).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import layers
from repro_torch.models.params import check_family

__all__ = ["embed_inputs", "make_block_fn", "transformer_logits",
           "transformer_prefill", "transformer_decode", "init_kv_cache"]


def _layer(params, l: int) -> Dict[str, torch.Tensor]:
    return {k: v[l] for k, v in params["blocks"].items()}


def embed_inputs(params, cfg: ModelConfig, batch: Dict[str, Any], ctx):
    check_family(cfg)
    h = layers.take_embedding(params["embed"], batch["tokens"], ctx)
    h = h.to(torch.bfloat16 if cfg.dtype == "bfloat16" else h.dtype)
    return ctx.constrain(h, "batch", "seq", "act_embed")


# ---------------------------------------------------------------------------
# One transformer block (attention + MLP)
# ---------------------------------------------------------------------------

def _project_qkv(x, blk, cfg, ctx):
    b, s, _ = x.shape
    q = layers.matmul_f32(x, blk["wq"])
    k = layers.matmul_f32(x, blk["wk"])
    v = layers.matmul_f32(x, blk["wv"])
    if cfg.attention_bias and "bq" in blk:
        q, k, v = q + blk["bq"], k + blk["bk"], v + blk["bv"]
    q = q.to(x.dtype).reshape(b, s, cfg.num_heads, cfg.head_dim)
    k = k.to(x.dtype).reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    v = v.to(x.dtype).reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    return q, k, v


def _apply_rope(q, k, cfg, positions, pos3d):
    if cfg.mrope and pos3d is not None:
        q = layers.mrope(q, pos3d, cfg.mrope_sections, cfg.rope_theta)
        k = layers.mrope(k, pos3d, cfg.mrope_sections, cfg.rope_theta)
    else:
        q = layers.rope(q, positions, cfg.rope_theta)
        k = layers.rope(k, positions, cfg.rope_theta)
    return q, k


def _mlp(x, blk, cfg, ctx):
    """Dense MLP sublayer. Returns (out, aux)."""
    if cfg.is_moe:
        raise NotImplementedError("MoE layers come with a later slice of "
                                  "the port")
    if cfg.mlp_type == "swiglu":
        return layers.swiglu(x, blk["w_gate"], blk["w_up"], blk["w_down"],
                             ctx), 0.0
    return layers.gelu_mlp(x, blk["w_up"], blk["w_down"], blk.get("b_up"),
                           blk.get("b_down"), ctx), 0.0


def _attn_out(out, blk, cfg, h):
    b, s = out.shape[:2]
    out = layers.matmul_f32(out.reshape(b, s, -1), blk["wo"])
    if cfg.attention_bias and "bo" in blk:
        out = out + blk["bo"]
    return h + out.to(h.dtype)


def make_block_fn(cfg: ModelConfig, ctx, positions, pos3d=None,
                  impl: Optional[str] = None, return_kv: bool = False):
    impl = impl or ctx.recipe.attn_impl

    def block(carry, blk):
        h, aux = carry
        x = layers.rms_norm(h, blk["ln1"], cfg.norm_eps)
        q, k, v = _project_qkv(x, blk, cfg, ctx)
        q, k = _apply_rope(q, k, cfg, positions, pos3d)
        out = attn_mod.attention(q, k, v, impl=impl, causal=True,
                                 block_kv=ctx.recipe.block_kv)
        h = _attn_out(out, blk, cfg, h)
        x2 = layers.rms_norm(h, blk["ln2"], cfg.norm_eps)
        y, aux_l = _mlp(x2, blk, cfg, ctx)
        h = ctx.constrain(h + y.to(h.dtype), "batch", "seq", "act_embed")
        return (h, aux + aux_l), ((k, v) if return_kv else None)

    return block


# ---------------------------------------------------------------------------
# Full forwards
# ---------------------------------------------------------------------------

def _positions(batch):
    tokens = batch["tokens"]
    b, s = tokens.shape[:2]
    return torch.arange(s, dtype=torch.int32,
                        device=tokens.device)[None].expand(b, s)


def _forward(params, cfg: ModelConfig, batch, ctx, return_kv: bool):
    """Final-normed hidden states and, with ``return_kv``, the stacked
    (L, B, S, Hk, Dh) K and V of every layer."""
    h = embed_inputs(params, cfg, batch, ctx)
    block = make_block_fn(cfg, ctx, _positions(batch),
                          batch.get("positions_3d"), return_kv=return_kv)
    kv = None
    carry = (h, 0.0)
    for l in range(cfg.num_layers):
        carry, ys = block(carry, _layer(params, l))
        if return_kv:
            if kv is None:
                kv = tuple(torch.empty((cfg.num_layers,) + y.shape,
                                       dtype=y.dtype, device=y.device)
                           for y in ys)
            kv[0][l], kv[1][l] = ys
    h, aux = carry
    return layers.rms_norm(h, params["final_ln"], cfg.norm_eps), aux, kv


def transformer_logits(params, cfg: ModelConfig, batch, ctx,
                       return_kv: bool = False):
    """(B, S, V) float32 logits, the auxiliary loss (0 for dense) and, with
    ``return_kv``, the stacked per-layer K/V."""
    h, aux, kv = _forward(params, cfg, batch, ctx, return_kv)
    return layers.matmul_f32(h, params["lm_head"]), aux, kv


def transformer_prefill(params, cfg: ModelConfig, batch, ctx):
    """Prefill: last-token logits + per-layer KV caches.

    Only the last position goes through the LM head: the same numbers as
    JAX's full logits sliced at -1, without the (B, S, V) tensor.
    """
    h, _, (k_cache, v_cache) = _forward(params, cfg, batch, ctx, True)
    return layers.matmul_f32(h[:, -1], params["lm_head"]), {"k": k_cache,
                                                           "v": v_cache}


def init_kv_cache(cfg: ModelConfig, batch_size: int, max_seq: int,
                  dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """The cache's shapes and dtype as ``meta`` tensors (JAX returns
    ``ShapeDtypeStruct``s); the engine allocates them on its device."""
    if dtype not in (torch.bfloat16, torch.float32):
        raise NotImplementedError(f"KV cache dtype {dtype}: the int8 cache "
                                  "comes with a later slice of the port")
    shape = (cfg.num_layers, batch_size, max_seq, cfg.num_kv_heads,
             cfg.head_dim)
    return {"k": torch.empty(shape, dtype=dtype, device="meta"),
            "v": torch.empty(shape, dtype=dtype, device="meta")}


def transformer_decode(params, cfg: ModelConfig, batch, cache, ctx):
    """One decode step: batch has tokens (B,1) and lengths (B,).

    Writes each layer's new K/V at ``lengths`` into ``cache`` in place and
    returns (last-token logits, cache).
    """
    if "k_scale" in cache:
        raise NotImplementedError("the int8 KV cache comes with a later "
                                  "slice of the port")
    lengths = batch["lengths"]
    h = embed_inputs(params, cfg, batch, ctx)                  # (B,1,D)
    pos = lengths[:, None].to(torch.int32)                     # (B,1)
    b = h.shape[0]
    bidx = torch.arange(b, device=h.device)
    impl = ctx.recipe.attn_impl
    for l in range(cfg.num_layers):
        blk = _layer(params, l)
        x = layers.rms_norm(h, blk["ln1"], cfg.norm_eps)
        q, k, v = _project_qkv(x, blk, cfg, ctx)
        q, k = _apply_rope(q, k, cfg, pos, None)
        k_l, v_l = cache["k"][l], cache["v"][l]
        k_l[bidx, lengths] = k[:, 0].to(k_l.dtype)
        v_l[bidx, lengths] = v[:, 0].to(v_l.dtype)
        out = attn_mod.decode_attention(q, k_l, v_l, lengths + 1, impl=impl)
        h = _attn_out(out, blk, cfg, h)
        x2 = layers.rms_norm(h, blk["ln2"], cfg.norm_eps)
        y, _ = _mlp(x2, blk, cfg, ctx)
        h = h + y.to(h.dtype)
    h = layers.rms_norm(h, params["final_ln"], cfg.norm_eps)
    return layers.matmul_f32(h[:, -1], params["lm_head"]), cache
