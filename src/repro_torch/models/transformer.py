"""Decoder-only transformer forward passes (dense / MoE / VLM / audio).

Mirrors ``repro/models/transformer.py``: embedding (token, VLM merge,
summed audio codebooks), the block function (dense MLP or MoE with shared
experts), full-sequence logits and the training loss, prefill (last-token
logits + per-layer KV) and one decode step against a static KV cache,
bfloat16 or int8 with per-(token, head) scales.  Depth is
:func:`scan_blocks`, a Python loop over the layers where JAX scans, with
JAX's remat policies as ``torch.utils.checkpoint``:

  * "none"   — store everything (inference / tiny models)
  * "block"  — checkpoint each layer
  * "nested" — two-level sqrt(L) grouping: an outer checkpoint a group of
               K layers keeps only group boundaries, and an inner one a
               layer keeps the group's recompute to K layer boundaries.

A layer-stacked leaf is an ``(L, ...)`` tensor, or a sequence of L
per-layer tensors (the train step's per-layer gradient leaves).  The
decode step writes the new token's K/V (and scales) into the cache in
place (JAX returns a new cache).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import is_dtensor
from repro_torch.models import attention as attn_mod
from repro_torch.models import layers, moe

__all__ = ["embed_inputs", "make_block_fn", "head_logits", "scan_blocks",
           "transformer_logits", "transformer_loss", "transformer_prefill",
           "transformer_decode", "init_kv_cache", "write_kv"]


def _layer(params, l: int) -> Dict[str, torch.Tensor]:
    return {k: v[l] for k, v in params["blocks"].items()}


# ---------------------------------------------------------------------------
# Depth loop with remat
# ---------------------------------------------------------------------------

def _nested_factors(num_layers: int) -> Tuple[int, int]:
    """Largest divisor of L that is <= sqrt(L) (outer group count)."""
    g = max(d for d in range(1, int(math.isqrt(num_layers)) + 1)
            if num_layers % d == 0)
    return g, num_layers // g


def _remat(fn):
    # the forward draws no random numbers, so no RNG state is kept
    return lambda *a: checkpoint(fn, *a, use_reentrant=False,
                                 preserve_rng_state=False)


def _run(body, carry, blks):
    ys = []
    for blk in blks:
        carry, y = body(carry, blk)
        ys.append(y)
    return carry, ys


def scan_blocks(body, carry, stacked, remat: str = "block"):
    """Run ``body(carry, blk) -> (carry, y)`` over the layers of
    ``stacked`` (a dict of layer-stacked leaves); returns the last carry
    and the list of per-layer ``y``."""
    num_layers = len(next(iter(stacked.values())))
    blks = [{k: v[l] for k, v in stacked.items()} for l in range(num_layers)]
    if remat == "none":
        return _run(body, carry, blks)
    if remat == "block":
        return _run(_remat(body), carry, blks)
    if remat == "nested":
        g, k = _nested_factors(num_layers)
        inner = _remat(body)
        outer = _remat(lambda c, group: _run(inner, c, group))
        ys = []
        for gi in range(g):
            carry, y = outer(carry, blks[gi * k:(gi + 1) * k])
            ys += y
        return carry, ys
    raise ValueError(f"unknown remat mode {remat!r}")


def embed_inputs(params, cfg: ModelConfig, batch: Dict[str, Any], ctx):
    if cfg.family == "audio":
        toks = batch["tokens"]                                 # (B, S, C)
        h = sum(layers.take_embedding(params["codebook_embed"][c],
                                      toks[..., c], ctx)
                for c in range(cfg.num_codebooks))
    else:
        h = layers.take_embedding(params["embed"], batch["tokens"], ctx)
    if cfg.family == "vlm" and "vision_embeds" in batch:
        vis = layers.matmul_f32(batch["vision_embeds"],
                                params["vision_proj"]).to(h.dtype)
        # frontend stub: vision tokens occupy the first num_vision_tokens slots
        h = torch.cat([vis, h[:, vis.shape[1]:]], dim=1)
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
    q = _heads(q.to(x.dtype), cfg.num_heads, cfg.head_dim, ctx)
    k = _heads(k.to(x.dtype), cfg.num_kv_heads, cfg.head_dim, ctx)
    v = _heads(v.to(x.dtype), cfg.num_kv_heads, cfg.head_dim, ctx)
    q = ctx.constrain(q, "batch", None, "heads", None)
    k = ctx.constrain(k, "batch", None, "heads", None)
    return q, k, v


def _heads(x, n: int, d: int, ctx):
    """(B, S, n*d) -> (B, S, n, d).  Under a mesh the flat projection is
    first redistributed to the placements of ("batch", None, "heads",
    None) (a split of n*d by heads), which the reshape can keep."""
    b, s = x.shape[:2]
    if ctx.mesh is None:
        return x.reshape(b, s, n, d)
    sh = ctx.sharding((b, s, n, d), ("batch", None, "heads", None))
    return x.redistribute(ctx.mesh, sh.placements).reshape(b, s, n, d)


def _apply_rope(q, k, cfg, positions, pos3d):
    if cfg.mrope and pos3d is not None:
        q = layers.mrope(q, pos3d, cfg.mrope_sections, cfg.rope_theta)
        k = layers.mrope(k, pos3d, cfg.mrope_sections, cfg.rope_theta)
    else:
        q = layers.rope(q, positions, cfg.rope_theta)
        k = layers.rope(k, positions, cfg.rope_theta)
    return q, k


def _mlp(x, blk, cfg, ctx):
    """Dense MLP or MoE sublayer. Returns (out, aux)."""
    if cfg.is_moe:
        out, aux = moe.moe_block(
            x, blk["router"], blk["moe_gate"], blk["moe_up"], blk["moe_down"],
            cfg.experts_per_tok, cfg.capacity_factor, ctx)
        if cfg.num_shared_experts:
            out = out + layers.swiglu(x, blk["sh_gate"], blk["sh_up"],
                                      blk["sh_down"], ctx)
        return out, aux
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


def _forward(params, cfg: ModelConfig, batch, ctx, return_kv: bool,
             remat: str = "none"):
    """Final-normed hidden states, the summed auxiliary loss and, with
    ``return_kv``, the stacked (L, B, S, Hk, Dh) K and V of every layer."""
    h = embed_inputs(params, cfg, batch, ctx)
    block = make_block_fn(cfg, ctx, _positions(batch),
                          batch.get("positions_3d"), return_kv=return_kv)
    (h, aux), ys = scan_blocks(block, (h, 0.0), params["blocks"], remat)
    kv = None
    if return_kv:
        kv = tuple(torch.stack([y[i] for y in ys]) for i in range(2))
    del ys
    return layers.rms_norm(h, params["final_ln"], cfg.norm_eps), aux, kv


def head_logits(params, cfg: ModelConfig, h, ctx=None):
    """Float32 logits of hidden states ``h`` (B, S, D) or (B, D): (..., V),
    or (..., C, V) for the audio family's per-codebook heads, constrained
    as JAX constrains its full logits (batch, seq, [codebook,] vocab on
    "heads"; the last position alone keeps the batch and vocab roles)."""
    if cfg.family == "audio":
        logits = torch.stack([layers.matmul_f32(h, w)
                              for w in params["lm_head"].unbind(0)], dim=-2)
    else:
        logits = layers.matmul_f32(h, params["lm_head"])
    if ctx is None:
        return logits
    dims = (("batch",) + ("seq",) * (h.dim() - 2)
            + (None,) * (cfg.family == "audio") + ("heads",))
    return ctx.constrain(logits, *dims)


def transformer_logits(params, cfg: ModelConfig, batch, ctx,
                       remat: str = "none", return_kv: bool = False):
    """(B, S, V) float32 logits ((B, S, C, V) for audio), the auxiliary
    loss (0 for dense) and, with ``return_kv``, the stacked per-layer K/V."""
    h, aux, kv = _forward(params, cfg, batch, ctx, return_kv, remat)
    return head_logits(params, cfg, h, ctx), aux, kv


def transformer_loss(params, cfg: ModelConfig, batch, ctx) -> torch.Tensor:
    """Next-token CE (mean over tokens); MoE adds 0.01 x the aux balance
    loss.  ``tokens`` (B, S+1) ((B, S+1, C) for audio); a VLM batch's
    ``positions_3d`` (3, B, S) and ``vision_embeds`` pass through."""
    tokens = batch["tokens"]
    batch_in = dict(batch, tokens=tokens[:, :-1])
    logits, aux, _ = transformer_logits(params, cfg, batch_in, ctx,
                                        remat=ctx.recipe.remat)
    return layers.softmax_xent(logits, tokens[:, 1:], ctx) + 0.01 * aux


def transformer_prefill(params, cfg: ModelConfig, batch, ctx):
    """Prefill: last-token logits + per-layer KV caches.

    Only the last position goes through the LM head: the same numbers as
    JAX's full logits sliced at -1, without the (B, S, V) tensor.
    """
    h, _, (k_cache, v_cache) = _forward(params, cfg, batch, ctx, True)
    k_cache = ctx.constrain(k_cache, None, "batch", "kv_seq", None, None)
    v_cache = ctx.constrain(v_cache, None, "batch", "kv_seq", None, None)
    return (head_logits(params, cfg, h[:, -1], ctx),
            {"k": k_cache, "v": v_cache})


def init_kv_cache(cfg: ModelConfig, batch_size: int, max_seq: int,
                  dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """The cache's shapes and dtype as ``meta`` tensors (JAX returns
    ``ShapeDtypeStruct``s); the engine allocates them on its device.  An
    int8 cache carries float32 per-(token, head) absmax scales beside it."""
    shape = (cfg.num_layers, batch_size, max_seq, cfg.num_kv_heads,
             cfg.head_dim)
    cache = {"k": torch.empty(shape, dtype=dtype, device="meta"),
             "v": torch.empty(shape, dtype=dtype, device="meta")}
    if dtype == torch.int8:
        # per-(token, head) absmax scales: ~6% overhead at head_dim 64,
        # halving decode's dominant HBM term (cache streaming)
        for name in ("k_scale", "v_scale"):
            cache[name] = torch.empty(shape[:-1], dtype=torch.float32,
                                      device="meta")
    return cache


def _quantize_kv(x):
    """x: (B, Hk, D) -> (int8 values, (B, Hk) float32 scales); rounds half
    to even, as ``jnp.round``."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1), min=1e-6) / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _put(dst, bidx, lengths, val):
    """``dst[b, lengths[b]] = val[b]`` in place for every row ``b``.  On a
    DTensor cache (B, S, ...), whose batch and length may be split, each
    rank writes in its own shard the rows of its batch rows whose length
    falls in its part of S (a row outside it rewrites its own value), so
    only the touched rows are read and written."""
    if not is_dtensor(dst):
        dst[bidx, lengths] = val.to(dst.dtype)
        return
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh, pl = dst.device_mesh, dst.placements
    loc = dst.to_local()
    n = loc.shape
    # where this rank's part of S starts: its chunk, major to minor over
    # the mesh dims that split S (evenly: a spec splits only what divides)
    chunk, coord = 0, mesh.get_coordinate()
    for i, p in enumerate(pl):
        if p == Shard(1):
            chunk = chunk * mesh.size(i) + coord[i]
    start = chunk * n[1]

    def rows(x, want):          # x (B, ...) as the rows of dst's shard
        if not is_dtensor(x):
            x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        return x.redistribute(mesh, want).to_local()

    v = rows(val, [Shard(p.dim - (p.dim > 1))
                   if isinstance(p, Shard) and p.dim != 1 else Replicate()
                   for p in pl]).to(loc.dtype)
    pos = rows(lengths, [p if p == Shard(0) else Replicate()
                         for p in pl]) - start
    inside = (pos >= 0) & (pos < n[1])
    inside = inside.reshape(inside.shape + (1,) * (v.dim() - 1))
    b = torch.arange(n[0], device=loc.device)
    pos = torch.clamp(pos, 0, n[1] - 1)
    loc[b, pos] = torch.where(inside, v, loc[b, pos])


def write_kv(cache, l: int, bidx, lengths, k, v):
    """Writes one token's K/V (B, 1, Hk, D) at ``lengths`` into layer ``l``
    of ``cache`` in place and returns the layer's (K, V) for attention:
    the cache itself, or an int8 cache dequantized.

    JAX dequantizes as ``int8.astype(bf16) * scale.astype(bf16)``.  That
    product of a 7-bit integer and a bf16 scale is exact in float32; the
    port rounds it to the activations' type: bfloat16 on the serve path
    (JAX's bf16 product), float32 for a float32 model (where XLA's CPU
    backend keeps the float32 product too)."""
    k_l, v_l = cache["k"][l], cache["v"][l]
    if "k_scale" not in cache:
        _put(k_l, bidx, lengths, k[:, 0])
        _put(v_l, bidx, lengths, v[:, 0])
        return k_l, v_l
    out = []
    for x, vals, scales in ((k, k_l, cache["k_scale"][l]),
                            (v, v_l, cache["v_scale"][l])):
        xq, xs = _quantize_kv(x[:, 0])
        _put(vals, bidx, lengths, xq)
        _put(scales, bidx, lengths, xs)
        out.append((vals.float() * scales[..., None].to(torch.bfloat16)
                    .float()).to(x.dtype))
    return tuple(out)


def transformer_decode(params, cfg: ModelConfig, batch, cache, ctx):
    """One decode step: batch has tokens (B,1) ((B,1,C) for audio) and
    lengths (B,).

    Writes each layer's new K/V at ``lengths`` into ``cache`` in place and
    returns (last-token logits, cache).
    """
    lengths = batch["lengths"]
    h = embed_inputs(params, cfg, batch, ctx)                  # (B,1,D)
    pos = lengths[:, None].to(torch.int32)                     # (B,1)
    # M-RoPE at a text position: the same id on all three channels
    pos3 = pos[None].expand(3, *pos.shape) if cfg.mrope else None
    b = h.shape[0]
    bidx = torch.arange(b, device=h.device)
    impl = ctx.recipe.attn_impl
    for l in range(cfg.num_layers):
        blk = _layer(params, l)
        x = layers.rms_norm(h, blk["ln1"], cfg.norm_eps)
        q, k, v = _project_qkv(x, blk, cfg, ctx)
        q, k = _apply_rope(q, k, cfg, pos, pos3)
        k_use, v_use = write_kv(cache, l, bidx, lengths, k, v)
        out = attn_mod.decode_attention(q, k_use, v_use, lengths + 1,
                                        impl=impl)
        h = _attn_out(out, blk, cfg, h)
        x2 = layers.rms_norm(h, blk["ln2"], cfg.norm_eps)
        y, _ = _mlp(x2, blk, cfg, ctx)
        h = h + y.to(h.dtype)
    h = layers.rms_norm(h, params["final_ln"], cfg.norm_eps)
    return head_logits(params, cfg, h[:, -1], ctx), cache
