"""Mamba2 (SSD) blocks and the Zamba2 hybrid (a Mamba2 backbone with a
SHARED attention+MLP block applied every ``shared_attn_every`` layers):
training logits and loss, and the decode step.

Mirrors ``repro/models/mamba2.py``.  The selective state space
runs in chunked form: scalar-per-head decays in log space, intra-chunk
pairs as dense (C x C) products with the positive exponents masked before
``exp``, the inter-chunk state carried by a Python loop over chunks where
JAX scans.  State is (B, H, head_dim, N).  The hybrid's prefill is
``model.hybrid_prefill``.  The (G, K) layer-stacked Mamba2 leaves are read
as ``leaf[g][k]``, so a leaf may also be nested per-layer sequences.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import layers
from repro_torch.models.transformer import (_attn_out, _mlp, _project_qkv,
                                            _remat, make_block_fn, write_kv)

__all__ = ["mamba2_block", "mamba2_block_decode", "hybrid_logits",
           "hybrid_loss", "hybrid_decode", "init_hybrid_state"]


def _softplus(x):
    """``jax.nn.softplus``: log(1 + e^x) with no linear cut-off."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _causal_conv(x, conv_w, conv_b, prev=None):
    """Depthwise causal conv1d: x (B,T,C), conv_w (W,C).

    ``prev`` (B,W-1,C) carries state across steps for decode.
    Returns (out (B,T,C), new_prev)."""
    w = conv_w.shape[0]
    if prev is None:
        prev = torch.zeros((x.shape[0], w - 1, x.shape[2]), dtype=x.dtype,
                           device=x.device)
    xp = torch.cat([prev, x], dim=1)                           # (B, T+W-1, C)
    out = sum(xp[:, i:i + x.shape[1]] * conv_w[i] for i in range(w))
    new_prev = xp[:, -(w - 1):] if w > 1 else prev
    return out + conv_b, new_prev


def _ssd_chunked(xh, b_in, c_in, dt, loga, state, chunk: int):
    """Chunked selective scan.

    xh: (B,T,H,P) inputs per head; b_in/c_in: (B,T,N); dt: (B,T,H);
    loga: (B,T,H) log decays (<= 0); state: (B,H,P,N).
    Returns (y (B,T,H,P) in xh's type, float32 state)."""
    t = xh.shape[1]
    f32 = torch.float32
    st = state.to(f32)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=xh.device))             # s <= t
    ys = []
    for c0 in range(0, t, chunk):
        xc, bc, cc, dtc, lac = (a[:, c0:c0 + chunk].to(f32)
                                for a in (xh, b_in, c_in, dt, loga))
        c = xc.shape[1]
        cum = torch.cumsum(lac, dim=1)                         # (B,c,H)
        # inter-chunk: y_state[t] = exp(cum_t) * C_t . state
        y = torch.einsum("bsn,bhpn->bshp", cc, st) * torch.exp(cum)[..., None]
        # intra-chunk: pairs s <= t
        expo = cum[:, :, None, :] - cum[:, None, :, :]         # (B,t,s,H)
        decay = torch.exp(torch.where(tri[:c, :c, None], expo,
                                      float("-inf")))
        cb = torch.einsum("btn,bsn->bts", cc, bc)              # (B,t,s)
        att = cb[..., None] * decay * dtc[:, None]             # (B,t,s,H)
        y = y + torch.einsum("btsh,bshp->bthp", att, xc)
        # state update
        w_end = torch.exp(cum[:, -1][:, None] - cum)           # (B,c,H)
        st = st * torch.exp(cum[:, -1])[..., None, None]
        st = st + torch.einsum("bshp,bsn->bhpn",
                               (w_end * dtc)[..., None] * xc, bc)
        ys.append(y)
    return torch.cat(ys, dim=1).to(xh.dtype), st


def _in_proj(h, blk, cfg, conv_prev, ctx=None):
    """The block's norm, projections and causal conv: (x-branch, z, B, C,
    dt, conv_state); the full-sequence block constrains the x-branch."""
    x = layers.rms_norm(h, blk["ln"], cfg.norm_eps)
    z = layers.matmul_f32(x, blk["wz"])
    xin = layers.matmul_f32(x, blk["wx"]).to(h.dtype)
    xin, conv_state = _causal_conv(xin, blk["conv_w"], blk["conv_b"],
                                   conv_prev)
    xin = F.silu(xin)
    if ctx is not None:
        xin = ctx.constrain(xin, "batch", None, "heads")
    b_in = layers.matmul_f32(x, blk["wB"])
    c_in = layers.matmul_f32(x, blk["wC"])
    dt = _softplus(layers.matmul_f32(x, blk["wdt"]) + blk["dt_bias"])
    return xin, z, b_in, c_in, dt, conv_state


def _out_proj(h, y, z, blk, cfg):
    y = layers.rms_norm(y * F.silu(z).to(y.dtype), blk["gn"], cfg.norm_eps)
    return h + layers.matmul_f32(y, blk["wo"]).to(h.dtype)


def mamba2_block(h, blk, cfg: ModelConfig, ctx, conv_prev=None,
                 ssm_prev=None):
    """Full-sequence Mamba2 block. Returns (h, (conv_state, ssm_state))."""
    bsz, t, d = h.shape
    din = cfg.expand * d
    nheads = din // cfg.ssm_head_dim
    p = cfg.ssm_head_dim
    xin, z, b_in, c_in, dt, conv_state = _in_proj(h, blk, cfg, conv_prev,
                                                  ctx)
    loga = -torch.exp(blk["a_log"]) * dt                       # (B,T,H), <= 0
    if ssm_prev is None:
        ssm_prev = torch.zeros((bsz, nheads, p, cfg.ssm_state_dim),
                               dtype=torch.float32, device=h.device)
    xh = xin.reshape(bsz, t, nheads, p)
    y, ssm_state = _ssd_chunked(xh, b_in, c_in, dt, loga, ssm_prev,
                                min(cfg.chunk_size, t))
    y = y + blk["d_skip"][None, None, :, None] * xh
    return _out_proj(h, y.reshape(bsz, t, din), z, blk, cfg), \
        (conv_state, ssm_state)


def mamba2_block_decode(h, blk, cfg, ctx, conv_prev, ssm_prev):
    """Single-token Mamba2 step (O(1) state update)."""
    bsz, _, d = h.shape
    din = cfg.expand * d
    nheads = din // cfg.ssm_head_dim
    p = cfg.ssm_head_dim
    xin, z, b_in, c_in, dt, conv_state = _in_proj(h, blk, cfg, conv_prev)
    a = torch.exp(-torch.exp(blk["a_log"]) * dt)[:, 0]         # (B,H)
    xh = xin.reshape(bsz, nheads, p).float()
    ssm_state = ssm_prev * a[..., None, None] + (
        dt[:, 0, :, None, None] * xh[..., None]
        * b_in[:, 0].float()[:, None, None, :])
    y = torch.einsum("bn,bhpn->bhp", c_in[:, 0].float(), ssm_state)
    y = y + blk["d_skip"][None, :, None] * xh
    y = y.reshape(bsz, 1, din).to(h.dtype)
    return _out_proj(h, y, z, blk, cfg), (conv_state, ssm_state)


# ---------------------------------------------------------------------------
# Zamba2 hybrid model
# ---------------------------------------------------------------------------

def hybrid_logits(params, cfg: ModelConfig, batch, ctx, remat: str = "none"):
    """(B, T, V) float32 logits of ``batch["tokens"]`` (B, T).  With any
    remat but "none" each group (K Mamba2 blocks and the shared block) is
    one checkpoint, as JAX checkpoints its group."""
    tokens = batch["tokens"]
    b, t = tokens.shape
    h = layers.take_embedding(params["embed"], tokens, ctx)
    h = h.to(torch.bfloat16 if cfg.dtype == "bfloat16" else h.dtype)
    h = ctx.constrain(h, "batch", "seq", "act_embed")
    positions = torch.arange(t, dtype=torch.int32,
                             device=tokens.device)[None].expand(b, t)
    shared_block = make_block_fn(cfg, ctx, positions)
    mamba = params["mamba"]

    def group(hh, gblks, shared):
        for blk in gblks:
            hh, _ = mamba2_block(hh, blk, cfg, ctx)
        (hh, _), _ = shared_block((hh, 0.0), shared)
        return hh

    grp = _remat(group) if remat != "none" else group
    groups, k_inner = len(mamba["ln"]), len(mamba["ln"][0])
    for gi in range(groups):
        h = grp(h, [{n: v[gi][ki] for n, v in mamba.items()}
                    for ki in range(k_inner)], params["shared"])
    h = layers.rms_norm(h, params["final_ln"], cfg.norm_eps)
    return ctx.constrain(layers.matmul_f32(h, params["lm_head"]),
                         "batch", "seq", "heads")


def hybrid_loss(params, cfg, batch, ctx):
    """Next-token CE of ``tokens`` (B, T+1), mean over tokens."""
    tokens = batch["tokens"]
    logits = hybrid_logits(params, cfg, dict(batch, tokens=tokens[:, :-1]),
                           ctx, remat=ctx.recipe.remat)
    return layers.softmax_xent(logits, tokens[:, 1:], ctx)


def init_hybrid_state(cfg: ModelConfig, batch_size: int, max_seq: int,
                      dtype=torch.bfloat16):
    """The decode state's shapes and dtypes as ``meta`` tensors: Mamba2
    conv and SSM states per (group, layer), and the shared attention
    block's KV cache, one per group invocation."""
    g = cfg.num_layers // cfg.shared_attn_every
    k = cfg.shared_attn_every
    din = cfg.expand * cfg.d_model
    nheads = din // cfg.ssm_head_dim
    kv = (g, batch_size, max_seq, cfg.num_kv_heads, cfg.head_dim)
    return {
        "conv": torch.empty((g, k, batch_size, cfg.conv_width - 1, din),
                            dtype=dtype, device="meta"),
        "ssm": torch.empty((g, k, batch_size, nheads, cfg.ssm_head_dim,
                            cfg.ssm_state_dim), dtype=torch.float32,
                           device="meta"),
        "k": torch.empty(kv, dtype=dtype, device="meta"),
        "v": torch.empty(kv, dtype=dtype, device="meta"),
    }


def hybrid_decode(params, cfg: ModelConfig, batch, state, ctx):
    """One decode step: Mamba states are O(1); the shared attention block
    keeps one KV cache per group invocation, written in place.  Returns
    (last-token logits, state with new conv and SSM leaves)."""
    lengths = batch["lengths"]
    tokens = batch["tokens"]                                   # (B,1)
    b = tokens.shape[0]
    h = layers.take_embedding(params["embed"], tokens, ctx)
    h = h.to(torch.bfloat16 if cfg.dtype == "bfloat16" else h.dtype)
    pos = lengths[:, None].to(torch.int32)
    shared = params["shared"]
    bidx = torch.arange(b, device=h.device)
    impl = ctx.recipe.attn_impl
    groups, k_inner = params["mamba"]["ln"].shape[:2]
    conv, ssm = [], []
    for gi in range(groups):
        conv_g, ssm_g = [], []
        for ki in range(k_inner):
            blk = {n: v[gi, ki] for n, v in params["mamba"].items()}
            h, (cp, sp) = mamba2_block_decode(h, blk, cfg, ctx,
                                              state["conv"][gi, ki],
                                              state["ssm"][gi, ki])
            conv_g.append(cp)
            ssm_g.append(sp)
        conv.append(torch.stack(conv_g))
        ssm.append(torch.stack(ssm_g))
        # shared attention with cache
        x = layers.rms_norm(h, shared["ln1"], cfg.norm_eps)
        q, k, v = _project_qkv(x, shared, cfg, ctx)
        q = layers.rope(q, pos, cfg.rope_theta)
        k = layers.rope(k, pos, cfg.rope_theta)
        k_g, v_g = write_kv(state, gi, bidx, lengths, k, v)
        out = attn_mod.decode_attention(q, k_g, v_g, lengths + 1, impl=impl)
        h = _attn_out(out, shared, cfg, h)
        x2 = layers.rms_norm(h, shared["ln2"], cfg.norm_eps)
        y, _ = _mlp(x2, shared, cfg, ctx)
        h = h + y.to(h.dtype)
    h = layers.rms_norm(h, params["final_ln"], cfg.norm_eps)
    logits = layers.matmul_f32(h[:, -1], params["lm_head"])
    return logits, dict(state, conv=torch.stack(conv), ssm=torch.stack(ssm))
