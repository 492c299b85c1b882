"""RWKV6 (Finch): token shift, data-dependent decay via LoRA, matrix-valued
state: the chunked full-sequence block (prefill and training), the O(1)
decode step, and the training logits and loss.

Mirrors ``repro/models/rwkv.py``.  Recurrence (per head, head_dim hd):

    S_t = diag(w_t) S_{t-1} + k_t^T v_t          (S: hd x hd)
    o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)

The chunked WKV keeps every exponent <= 0.  JAX's chunk form multiplies
``r_t exp(cum_{t-1})`` by ``k_s exp(-cum_s)``, whose exponent grows with
the chunk (with log decays of -1, ``exp(-cum)`` overflows float32 past 88
steps and the product is NaN at chunk 128).  Here the intra-chunk pairs
take ``exp(cum_{t-1} - cum_s)`` for s < t directly (the masked pairwise
decay of ``mamba2._ssd_chunked``), so the function is JAX's wherever JAX's
is finite and stays finite where JAX's is not.  The pairwise tensor is
(B, c, c, H, hd) float32 a chunk (671 MB at rwkv6-3b's batch 4, chunk 128).
Masked pairs enter ``exp`` as -inf and leave as 0, so their derivative is
0 too: no inf meets a zero cotangent in the backward.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers
from repro_torch.models.transformer import scan_blocks

__all__ = ["rwkv_block", "rwkv_block_decode", "rwkv_logits", "rwkv_loss",
           "rwkv_decode", "rwkv_embed", "init_rwkv_state"]


def _mm(x, w):
    """``jnp.einsum`` without ``preferred_element_type``: accumulated in
    float32, returned in the operands' promoted type."""
    return layers.matmul_f32(x, w).to(torch.promote_types(x.dtype, w.dtype))


def _token_shift(x, prev):
    """x_{t-1} with ``prev`` filling slot -1 of the previous chunk/step."""
    return torch.cat([prev[:, None], x[:, :-1]], dim=1)


def _ddlerp(x, sx, tm_mix, lora_a, lora_b):
    """RWKV6 data-dependent interpolation for the 5 mix channels."""
    base = x + sx * tm_mix[0]
    ddd = torch.tanh(layers.matmul_f32(base, lora_a))
    ddd = ddd.reshape(*ddd.shape[:2], 5, -1)                   # (B,T,5,rank)
    deltas = torch.einsum("btfr,frd->btfd", ddd,
                          lora_b.float()).to(x.dtype)
    return [x + sx * (tm_mix[f] + deltas[:, :, f]) for f in range(5)]


def _log_decay(mw, blk):
    return -torch.exp(blk["w0"] + _mm(torch.tanh(_mm(mw, blk["decay_lora_a"])),
                                      blk["decay_lora_b"]))


def _wkv_chunked(r, k, v, logw, u, state, chunk: int):
    """Chunked WKV: r,k,v,logw (B,T,H,hd); u (H,hd); state (B,H,hd,hd).
    Returns (o (B,T,H,hd) in r's type, float32 state)."""
    b, t, h, hd = r.shape
    f32 = torch.float32
    state = state.to(f32)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=r.device), diagonal=-1)   # s < t
    outs = []
    for c0 in range(0, t, chunk):
        rc, kc, vc, lwc = (a[:, c0:c0 + chunk].to(f32)
                           for a in (r, k, v, logw))            # (B,c,H,hd)
        c = rc.shape[1]
        cum = torch.cumsum(lwc, dim=1)                          # inclusive
        cum_prev = cum - lwc                                    # exclusive
        # inter-chunk: contribution of the carried state
        o = torch.einsum("bthd,bhde->bthe", rc * torch.exp(cum_prev), state)
        # intra-chunk pairs s < t: decay exp(cum_prev[t] - cum[s]) <= 0
        expo = cum_prev[:, :, None] - cum[:, None]              # (B,t,s,H,hd)
        mask = tri[:c, :c, None, None]
        pair = torch.exp(torch.where(mask, expo, float("-inf")))
        del expo
        att = (pair * rc[:, :, None] * kc[:, None]).sum(-1)     # (B,t,s,H)
        del pair
        o = o + torch.einsum("btsh,bshe->bthe", att, vc)
        # diagonal (bonus u)
        o = o + (rc * kc * u).sum(-1, keepdim=True) * vc
        # state update
        kw = kc * torch.exp(cum[:, -1:] - cum)
        state = state * torch.exp(cum[:, -1])[..., None]       # decay k-dim
        state = state + torch.einsum("bshd,bshe->bhde", kw, vc)
        outs.append(o)
    return torch.cat(outs, dim=1).to(r.dtype), state


def _channel_mix(h, blk, cfg, x2, sx2):
    xk = x2 + sx2 * blk["cm_mix"][0]
    xr = x2 + sx2 * blk["cm_mix"][1]
    kk = torch.square(F.relu(layers.matmul_f32(xk, blk["cm_k"])))
    kv = layers.matmul_f32(kk.to(h.dtype), blk["cm_v"])
    gate = torch.sigmoid(layers.matmul_f32(xr, blk["cm_r"]))
    return h + (gate * kv).to(h.dtype)


def rwkv_block(h, blk, cfg: ModelConfig, ctx, tm_prev=None, cm_prev=None,
               att_state=None):
    """Full-sequence RWKV block. Returns (h, (tm_last, cm_last, att_state))."""
    b, t, d = h.shape
    hh, hd = cfg.num_heads, cfg.ssm_head_dim
    if tm_prev is None:
        tm_prev = torch.zeros((b, d), dtype=h.dtype, device=h.device)
        cm_prev = torch.zeros((b, d), dtype=h.dtype, device=h.device)
        att_state = torch.zeros((b, hh, hd, hd), dtype=torch.float32,
                                device=h.device)

    # ---- time mix ----
    x = layers.rms_norm(h, blk["ln1"], cfg.norm_eps)
    sx = _token_shift(x, tm_prev) - x
    mr, mk, mv, mw, mg = _ddlerp(x, sx, blk["tm_mix"], blk["tm_lora_a"],
                                 blk["tm_lora_b"])
    r = _mm(mr, blk["wr"]).reshape(b, t, hh, hd)
    k = _mm(mk, blk["wk"]).reshape(b, t, hh, hd)
    v = _mm(mv, blk["wv"]).reshape(b, t, hh, hd)
    g = _mm(mg, blk["wg"])
    logw = _log_decay(mw, blk).reshape(b, t, hh, hd).float()
    u = blk["bonus_u"].float()
    o, att_state = _wkv_chunked(r, k, v, logw, u, att_state,
                                min(cfg.chunk_size, t))
    # per-head normalization (GroupNorm stand-in) + gate
    o = o.reshape(b, t, d)
    o = layers.rms_norm(o, blk["ln_x"], cfg.norm_eps) * F.silu(g.to(o.dtype))
    h = h + _mm(o, blk["w_att_out"]).to(h.dtype)
    tm_last = x[:, -1]

    # ---- channel mix ----
    x2 = layers.rms_norm(h, blk["ln2"], cfg.norm_eps)
    h = _channel_mix(h, blk, cfg, x2, _token_shift(x2, cm_prev) - x2)
    return h, (tm_last, x2[:, -1], att_state)


def rwkv_block_decode(h, blk, cfg, ctx, tm_prev, cm_prev, att_state):
    """Single-token step using the O(1) recurrence directly."""
    b, d = h.shape[0], h.shape[-1]
    hh, hd = cfg.num_heads, cfg.ssm_head_dim
    x = layers.rms_norm(h, blk["ln1"], cfg.norm_eps)            # (B,1,D)
    sx = tm_prev[:, None] - x
    mr, mk, mv, mw, mg = _ddlerp(x, sx, blk["tm_mix"], blk["tm_lora_a"],
                                 blk["tm_lora_b"])
    rf = _mm(mr, blk["wr"]).reshape(b, hh, hd).float()
    kf = _mm(mk, blk["wk"]).reshape(b, hh, hd).float()
    vf = _mm(mv, blk["wv"]).reshape(b, hh, hd).float()
    g = _mm(mg, blk["wg"])[:, 0]
    w = torch.exp(_log_decay(mw, blk)).reshape(b, hh, hd).float()
    u = blk["bonus_u"].float()
    o = torch.einsum("bhd,bhde->bhe", rf, att_state) \
        + (rf * kf * u).sum(-1, keepdim=True) * vf
    att_state = att_state * w[..., None] + kf[..., None] * vf[:, :, None]
    o = o.reshape(b, 1, d).to(h.dtype)
    o = layers.rms_norm(o, blk["ln_x"], cfg.norm_eps) * F.silu(g[:, None])
    h = h + _mm(o, blk["w_att_out"]).to(h.dtype)
    tm_last = x[:, 0]

    x2 = layers.rms_norm(h, blk["ln2"], cfg.norm_eps)
    h = _channel_mix(h, blk, cfg, x2, cm_prev[:, None] - x2)
    return h, (tm_last, x2[:, 0], att_state)


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------

def rwkv_embed(params, cfg, tokens, ctx):
    h = layers.take_embedding(params["embed"], tokens, ctx)
    h = h.to(torch.bfloat16 if cfg.dtype == "bfloat16" else h.dtype)
    return ctx.constrain(h, "batch", "seq", "act_embed")


def rwkv_logits(params, cfg: ModelConfig, batch, ctx, remat: str = "none"):
    """(B, T, V) float32 logits of ``batch["tokens"]`` (B, T)."""
    h = rwkv_embed(params, cfg, batch["tokens"], ctx)
    h, _ = scan_blocks(lambda hh, blk: (rwkv_block(hh, blk, cfg, ctx)[0], None),
                       h, params["blocks"], remat)
    h = layers.rms_norm(h, params["final_ln"], cfg.norm_eps)
    return ctx.constrain(layers.matmul_f32(h, params["lm_head"]),
                         "batch", "seq", "heads")


def rwkv_loss(params, cfg, batch, ctx):
    """Next-token CE of ``tokens`` (B, T+1), mean over tokens."""
    tokens = batch["tokens"]
    logits = rwkv_logits(params, cfg, dict(batch, tokens=tokens[:, :-1]), ctx,
                         remat=ctx.recipe.remat)
    return layers.softmax_xent(logits, tokens[:, 1:], ctx)


def init_rwkv_state(cfg: ModelConfig, batch_size: int,
                    dtype=torch.bfloat16):
    """The recurrent state's shapes and dtypes as ``meta`` tensors."""
    l, d = cfg.num_layers, cfg.d_model
    h, hd = cfg.num_heads, cfg.ssm_head_dim
    return {
        "att": torch.empty((l, batch_size, h, hd, hd), dtype=torch.float32,
                           device="meta"),
        "tm": torch.empty((l, batch_size, d), dtype=dtype, device="meta"),
        "cm": torch.empty((l, batch_size, d), dtype=dtype, device="meta"),
    }


def _layer(params, l: int):
    return {k: v[l] for k, v in params["blocks"].items()}


def rwkv_decode(params, cfg: ModelConfig, batch, state, ctx):
    """One decode step with O(1) state; no KV cache.  Returns (last-token
    logits, a new state: JAX's, whose leaves take the step's types)."""
    h = rwkv_embed(params, cfg, batch["tokens"], ctx)          # (B,1,D)
    new = {"tm": [], "cm": [], "att": []}
    for l in range(cfg.num_layers):
        h, (tm, cm, att) = rwkv_block_decode(
            h, _layer(params, l), cfg, ctx, state["tm"][l], state["cm"][l],
            state["att"][l])
        for name, x in (("tm", tm), ("cm", cm), ("att", att)):
            new[name].append(x)
    h = layers.rms_norm(h, params["final_ln"], cfg.norm_eps)
    logits = layers.matmul_f32(h[:, -1], params["lm_head"])
    return logits, {name: torch.stack(xs) for name, xs in new.items()}
