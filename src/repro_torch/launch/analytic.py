"""Analytic per-device roofline accounting.

A copy of ``repro/launch/analytic.py`` (numpy only) with its imports
rewritten, so ``cell_cost`` is the JAX package's function exactly.  Every
non-pod collective is priced at one ``ici_bw``: on the H100 production
mesh the "data" axis crosses InfiniBand between nodes while only "model"
stays on NVLink, a difference this model does not see (PERF.md).

Why analytic: XLA's ``compiled.cost_analysis()`` counts a while-loop body
ONCE, so any scan (layers, KV blocks, SSD chunks, microbatches) makes its
FLOPs/bytes meaningless at production depth (verified empirically — see
EXPERIMENTS.md §Roofline methodology).  We therefore account the dominant
terms in closed form from the einsum dimensions — the same arithmetic the
lowered HLO performs — and cross-validate against ``cost_analysis`` on small
unrolled configs in tests/test_roofline_validation.py.

Accounting policy (documented, deliberately conservative):
 * FLOPs: every matmul/einsum at 2*m*k*n; attention counted as implemented
   (full S^2, no causal pruning — the blockwise scan really does that);
   train = 3x forward matmul FLOPs (bwd two matmuls per fwd matmul);
   elementwise/norm/rope excluded (<3%).
 * HBM bytes: weights touched per step (FSDP-gathered copies read once per
   microbatch, x2 for nested-remat recompute), activations at major-op
   read+write granularity, KV-cache/state traffic, optimizer state traffic.
 * Collectives: FSDP weight all-gathers, gradient reduce-scatter+all-gather
   (or DCN all-reduce across pods), TP activation all-reduces, vocab-parallel
   logits reductions, decode split-K softmax reductions.

Everything is PER DEVICE, matching the SPMD per-device program.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.distributed.sharding import Recipe
from repro_torch.models.params import padded_experts

__all__ = ["CellCost", "cell_cost"]

BF16 = 2
F32 = 4


@dataclasses.dataclass
class CellCost:
    flops: float                 # per device
    hbm_bytes: float             # per device
    collective_bytes: float      # per device (ICI)
    dcn_bytes: float             # per device (cross-pod)
    model_flops: float           # 6*N*D (train) / 2*N_active*tokens (serve), global
    breakdown: Dict[str, float]

    def terms(self, hw, n_devices: int) -> Dict[str, float]:
        return {
            "compute_s": self.flops / hw.peak_flops,
            "memory_s": self.hbm_bytes / hw.hbm_bw,
            "collective_s": self.collective_bytes / hw.ici_bw
            + self.dcn_bytes / hw.dcn_bw,
        }


def _mesh_sizes(recipe: Recipe, mesh_shape: Dict[str, int]):
    dp = int(np.prod([mesh_shape.get(a, 1) for a in recipe.batch_axes]))
    fsdp = int(np.prod([mesh_shape.get(a, 1) for a in recipe.fsdp_axes]))
    tp = int(np.prod([mesh_shape.get(a, 1) for a in recipe.tp_axes]))
    pods = mesh_shape.get("pod", 1)
    return dp, fsdp, tp, pods


def _layer_matmul_flops_per_token(cfg: ModelConfig) -> float:
    """2 * (active matmul params per layer) — projections only."""
    d, hd = cfg.d_model, cfg.head_dim
    attn = d * (cfg.num_heads * hd) + 2 * d * (cfg.num_kv_heads * hd) \
        + (cfg.num_heads * hd) * d
    mult = 3 if cfg.mlp_type == "swiglu" else 2
    if cfg.is_moe:
        fe = cfg.moe_d_ff or cfg.d_ff
        eff_experts = cfg.experts_per_tok * cfg.capacity_factor
        mlp = (eff_experts + cfg.num_shared_experts) * mult * d * fe \
            + d * cfg.num_experts
    else:
        mlp = mult * d * cfg.d_ff
    return 2.0 * (attn + mlp)


def _rwkv_layer_flops_per_token(cfg: ModelConfig) -> float:
    d, f = cfg.d_model, cfg.d_ff
    h, hd = cfg.num_heads, cfg.ssm_head_dim
    c = cfg.chunk_size
    proj = 2.0 * (5 * d * d + d * 5 * 32 * 2 + d * 64 * 2)        # r,k,v,g,out + loras
    # chunked WKV per token: att row (c * hd), state in/out (2 * hd^2), pv (c * hd)
    wkv = 2.0 * h * (2 * c * hd + 3 * hd * hd)
    cm = 2.0 * (d * f * 2 + d * d)
    return proj + wkv + cm


def _mamba_layer_flops_per_token(cfg: ModelConfig) -> float:
    d = cfg.d_model
    din = cfg.expand * d
    n = cfg.ssm_state_dim
    h = din // cfg.ssm_head_dim
    p = cfg.ssm_head_dim
    c = cfg.chunk_size
    proj = 2.0 * (2 * d * din + 2 * d * n + d * h + din * d)
    conv = 2.0 * cfg.conv_width * din
    # chunked SSD per token: cb (c*n), att*x (c*h*p), state io (2*h*p*n)
    ssd = 2.0 * (c * n + c * h * p + 3 * h * p * n)
    return proj + conv + ssd


def _attn_quadratic_flops(cfg: ModelConfig, tokens: float, kv_len: float) -> float:
    """scores + pv: 4 * H * Dh per (token x kv) pair — as implemented (no
    causal pruning in the blockwise scan)."""
    return 4.0 * cfg.num_heads * cfg.head_dim * tokens * kv_len


def _param_bytes(cfg: ModelConfig, dtype_bytes: int) -> float:
    return float(cfg.param_count()) * dtype_bytes


def cell_cost(cfg: ModelConfig, shape: ShapeSpec, recipe: Recipe,
              mesh_shape: Dict[str, int]) -> CellCost:
    dp, fsdp, tp, pods = _mesh_sizes(recipe, mesh_shape)
    n_dev = int(np.prod(list(mesh_shape.values())))
    b, s = shape.global_batch, shape.seq_len
    l = cfg.num_layers
    d, v = cfg.d_model, cfg.vocab_size

    # --- tokens processed this step
    if shape.kind == "train":
        tokens = float(b) * s
    elif shape.kind == "prefill":
        tokens = float(b) * s
    else:
        tokens = float(b)

    # --- per-layer forward matmul flops per token
    if cfg.family == "rwkv":
        per_layer = _rwkv_layer_flops_per_token(cfg)
    elif cfg.family == "hybrid":
        g = l // cfg.shared_attn_every
        per_layer = _mamba_layer_flops_per_token(cfg)  # for each mamba layer
    else:
        per_layer = _layer_matmul_flops_per_token(cfg)

    fwd = per_layer * l * tokens
    if cfg.family == "hybrid":
        g = l // cfg.shared_attn_every
        fwd += g * _layer_matmul_flops_per_token(cfg) * tokens  # shared blocks

    # attention quadratic term
    kv_len = float(s) if shape.kind != "decode" else float(s)
    attn_q = 0.0
    if cfg.family in ("dense", "moe", "vlm", "audio"):
        per_tok_kv = kv_len
        attn_q = _attn_quadratic_flops(cfg, tokens, per_tok_kv) * l
    elif cfg.family == "hybrid":
        g = l // cfg.shared_attn_every
        attn_q = _attn_quadratic_flops(cfg, tokens, kv_len) * g

    # lm head (+ embedding matmul-free)
    heads = max(1, cfg.num_codebooks or 1)
    if shape.kind == "train":
        head_flops = 2.0 * tokens * d * v * heads
    elif shape.kind == "prefill":
        head_flops = 2.0 * b * d * v * heads          # last position only
    else:
        head_flops = 2.0 * b * d * v * heads

    mult = 3.0 if shape.kind == "train" else 1.0
    total_flops = mult * (fwd + attn_q + head_flops)
    flops_dev = total_flops / n_dev

    # --- model flops (the "useful" 6ND yardstick)
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        model_flops = 6.0 * n_active * tokens
    else:
        model_flops = 2.0 * n_active * tokens

    # --- HBM bytes per device
    p_total = float(cfg.param_count())
    p_dev = p_total / (fsdp * tp)                      # 2D-sharded storage
    bk = {}
    if shape.kind == "train":
        mb = max(recipe.microbatch, 1)
        remat_mult = 2.0 if recipe.remat in ("block", "nested") else 1.0
        # weights: gathered bf16 copy read per microbatch (and per remat pass)
        w_bytes = p_total / tp * BF16 * mb * (1 + remat_mult)  # fwd + bwd reads
        opt_state_b = {"int8": 2, "bfloat16": 4}.get(
            recipe.moment_dtype or cfg.opt_moment_dtype, 8)
        master_b = BF16 if recipe.param_dtype == "bfloat16" else F32
        grad_b = BF16 if recipe.grad_dtype == "bfloat16" else F32
        opt_bytes = p_dev * (master_b * 2 + opt_state_b * 2 + grad_b * 2 + BF16)
        act_elems = tokens * d * (14 if not cfg.is_moe else 20) * l
        act_bytes = act_elems * BF16 * remat_mult / n_dev
        logits_bytes = 2 * tokens * v * F32 / n_dev * heads
        hbm = w_bytes / 1 + opt_bytes + act_bytes + logits_bytes
        bk.update(weights=w_bytes, opt=opt_bytes, acts=act_bytes,
                  logits=logits_bytes)
    elif shape.kind == "prefill":
        w_bytes = p_total / tp * BF16
        act_bytes = tokens * d * 14 * l * BF16 / n_dev
        cache_bytes = 2.0 * l * b * s * cfg.num_kv_heads * cfg.head_dim * BF16 / n_dev
        hbm = w_bytes + act_bytes + cache_bytes
        bk.update(weights=w_bytes, acts=act_bytes, cache=cache_bytes)
    else:  # decode
        w_bytes = p_total / (fsdp * tp) * BF16         # every param read once
        kv_b = 1 if recipe.kv_cache_dtype == "int8" else BF16
        if cfg.family == "rwkv":
            state = l * b * cfg.num_heads * cfg.ssm_head_dim**2 * F32 * 2
        elif cfg.family == "hybrid":
            g = l // cfg.shared_attn_every
            din = cfg.expand * d
            state = l * b * (din // cfg.ssm_head_dim) * cfg.ssm_head_dim \
                * cfg.ssm_state_dim * F32 * 2
            state += 2.0 * g * b * s * cfg.num_kv_heads * cfg.head_dim * kv_b
        else:
            # int8 cache adds per-(token,head) f32 scales (~Dh/4 overhead)
            scale_b = (F32 / cfg.head_dim) if kv_b == 1 else 0.0
            state = 2.0 * l * b * s * cfg.num_kv_heads * cfg.head_dim * (kv_b + scale_b)
        hbm = w_bytes + state / n_dev   # state is global, sharded over devices
        bk.update(weights=w_bytes, cache=state / n_dev)

    # --- collective bytes per device
    ici = 0.0
    dcn = 0.0
    if shape.kind == "train":
        mb = max(recipe.microbatch, 1)
        # FSDP all-gather: each device receives the other shards, per mb and
        # again for the remat backward pass.
        gather_passes = mb * (2 if recipe.remat != "none" else 1) + mb  # fwd(+remat) + bwd
        ici += (p_total / tp * BF16) * (1 - 1 / fsdp) * gather_passes
        # grad reduce-scatter + all-gather of updates (~2x shard traffic)
        ici += 2.0 * (p_total / tp * F32) * (1 - 1 / fsdp)
        # TP activation all-reduces: 2 sublayers per layer, ring 2x payload
        tp_payload = tokens / dp / max(pods, 1) * d * BF16
        if tp > 1:
            ici += 2.0 * l * mb * 2.0 * (tp_payload / mb) * (1 - 1 / tp)
        # logits reduction (vocab-parallel softmax): per token scalar-ish — skip
        if pods > 1:
            grad_payload = p_total / (fsdp * tp) * (1 if recipe.compress_pod_grads else 4)
            dcn += 2.0 * grad_payload * (1 - 1 / pods)
    else:
        # serving: weight gathers only if fsdp-sharded storage feeds compute;
        # the weight-stationary recipe (act_embed sharding) replaces them
        # with per-layer activation all-reduces.
        if recipe.act_embed_axes:
            layers_n = cfg.num_layers
            ici += 2.0 * layers_n * (tokens * cfg.d_model * BF16) * (1 - 1 / fsdp)
        elif fsdp > 1:
            ici += (p_total / tp * BF16) * (1 - 1 / fsdp)
        if tp > 1:
            tp_payload = tokens / dp / max(pods, 1) * d * BF16
            n_attn = (cfg.num_layers if cfg.family not in ("rwkv", "hybrid")
                      else (cfg.num_layers // max(cfg.shared_attn_every, 1)
                            if cfg.family == "hybrid" else 0))
            layers_with_tp = cfg.num_layers
            ici += 2.0 * layers_with_tp * tp_payload * (1 - 1 / tp)
        if shape.kind == "decode" and cfg.family not in ("rwkv",):
            # split-K softmax partials across kv_seq shards
            ici += b / dp * cfg.num_heads * cfg.head_dim * F32 * \
                cfg.num_layers * (1 - 1 / tp) * 2

    return CellCost(
        flops=flops_dev,
        hbm_bytes=hbm,
        collective_bytes=ici,
        dcn_bytes=dcn,
        model_flops=model_flops,
        breakdown=bk,
    )
