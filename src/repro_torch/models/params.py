"""Parameter templates and initialization for every architecture family.

Mirrors ``repro/models/params.py``: ``param_defs`` builds the nested dict of
:class:`ParamDef` (layer-stacked leaves carry a leading L dim, or (G, K) for
the Zamba2 hybrid's Mamba2 blocks; the same keys and layout as the JAX
pytree, so ``convert.params_from_jax`` maps one onto the other), and
``init_params`` draws the weights.

``init_params`` takes an explicit ``torch.Generator``, dtype and device.
Each normal leaf is drawn in float32 and cast, as JAX does, but one layer
at a time: a full-width stacked leaf such as yi-34b's ``w_gate`` (60 x 7168
x 20480) would need 35 GB of float32 scratch if drawn whole.  The numbers
differ from ``jax.random``'s; tests that compare the two packages carry the
JAX weights across instead.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import ParamDef

__all__ = ["param_defs", "init_params", "param_shapes", "padded_experts"]

#: Leading stacked dims of the layer-stacked subtrees (drawn a slice at a time).
_STACKED = {"blocks": 1, "mamba": 2}


def padded_experts(num_experts: int) -> int:
    """Pad routed-expert count to a multiple of 16 for even EP sharding
    (mesh-independent so checkpoints stay portable)."""
    if num_experts >= 16 and num_experts % 16 != 0:
        return ((num_experts + 15) // 16) * 16
    return num_experts


def _attn_defs(cfg: ModelConfig, lead=()) -> Dict[str, ParamDef]:
    d = cfg.d_model
    qd = cfg.num_heads * cfg.head_dim
    kd = cfg.num_kv_heads * cfg.head_dim
    lead_dims = (None,) * len(lead)
    defs = {
        "ln1": ParamDef(lead + (d,), lead_dims + (None,), init="ones"),
        "wq": ParamDef(lead + (d, qd), lead_dims + ("fsdp", "tp")),
        "wk": ParamDef(lead + (d, kd), lead_dims + ("fsdp", "tp")),
        "wv": ParamDef(lead + (d, kd), lead_dims + ("fsdp", "tp")),
        "wo": ParamDef(lead + (qd, d), lead_dims + ("tp", "fsdp")),
    }
    if cfg.attention_bias:
        defs.update({
            "bq": ParamDef(lead + (qd,), lead_dims + ("tp",), init="zeros"),
            "bk": ParamDef(lead + (kd,), lead_dims + ("tp",), init="zeros"),
            "bv": ParamDef(lead + (kd,), lead_dims + ("tp",), init="zeros"),
            "bo": ParamDef(lead + (d,), lead_dims + (None,), init="zeros"),
        })
    return defs


def _mlp_defs(cfg: ModelConfig, lead=()) -> Dict[str, ParamDef]:
    d, f = cfg.d_model, cfg.d_ff
    lead_dims = (None,) * len(lead)
    defs: Dict[str, ParamDef] = {
        "ln2": ParamDef(lead + (d,), lead_dims + (None,), init="ones"),
    }
    if cfg.is_moe:
        e = cfg.num_experts
        ep = padded_experts(e)
        fe = cfg.moe_d_ff or f
        defs["router"] = ParamDef(lead + (d, e), lead_dims + ("fsdp", None))
        defs["moe_gate"] = ParamDef(lead + (ep, d, fe),
                                    lead_dims + ("ep", "fsdp", None))
        defs["moe_up"] = ParamDef(lead + (ep, d, fe),
                                  lead_dims + ("ep", "fsdp", None))
        defs["moe_down"] = ParamDef(lead + (ep, fe, d),
                                    lead_dims + ("ep", None, "fsdp"))
        if cfg.num_shared_experts:
            fs = cfg.num_shared_experts * fe
            defs["sh_gate"] = ParamDef(lead + (d, fs), lead_dims + ("fsdp", "tp"))
            defs["sh_up"] = ParamDef(lead + (d, fs), lead_dims + ("fsdp", "tp"))
            defs["sh_down"] = ParamDef(lead + (fs, d), lead_dims + ("tp", "fsdp"))
    elif cfg.mlp_type == "swiglu":
        defs["w_gate"] = ParamDef(lead + (d, f), lead_dims + ("fsdp", "tp"))
        defs["w_up"] = ParamDef(lead + (d, f), lead_dims + ("fsdp", "tp"))
        defs["w_down"] = ParamDef(lead + (f, d), lead_dims + ("tp", "fsdp"))
    else:  # gelu
        defs["w_up"] = ParamDef(lead + (d, f), lead_dims + ("fsdp", "tp"))
        defs["w_down"] = ParamDef(lead + (f, d), lead_dims + ("tp", "fsdp"))
        if cfg.attention_bias:
            defs["b_up"] = ParamDef(lead + (f,), lead_dims + ("tp",),
                                    init="zeros")
            defs["b_down"] = ParamDef(lead + (d,), lead_dims + (None,),
                                      init="zeros")
    return defs


def _rwkv_block_defs(cfg: ModelConfig, lead=()) -> Dict[str, ParamDef]:
    d, f = cfg.d_model, cfg.d_ff
    h, hd = cfg.num_heads, cfg.ssm_head_dim
    lead_dims = (None,) * len(lead)
    lora = 32
    return {
        "ln1": ParamDef(lead + (d,), lead_dims + (None,), init="ones"),
        "ln2": ParamDef(lead + (d,), lead_dims + (None,), init="ones"),
        "tm_mix": ParamDef(lead + (5, d), lead_dims + (None, None),
                           init="zeros"),
        "tm_lora_a": ParamDef(lead + (d, 5 * lora), lead_dims + ("fsdp", None)),
        "tm_lora_b": ParamDef(lead + (5, lora, d),
                              lead_dims + (None, None, "fsdp"), init="zeros"),
        "w0": ParamDef(lead + (d,), lead_dims + (None,), init="zeros"),
        "decay_lora_a": ParamDef(lead + (d, 64), lead_dims + ("fsdp", None)),
        "decay_lora_b": ParamDef(lead + (64, d), lead_dims + (None, "fsdp"),
                                 init="zeros"),
        "bonus_u": ParamDef(lead + (h, hd), lead_dims + (None, None),
                            init="zeros"),
        "wr": ParamDef(lead + (d, d), lead_dims + ("fsdp", "tp")),
        "wk": ParamDef(lead + (d, d), lead_dims + ("fsdp", "tp")),
        "wv": ParamDef(lead + (d, d), lead_dims + ("fsdp", "tp")),
        "wg": ParamDef(lead + (d, d), lead_dims + ("fsdp", "tp")),
        "w_att_out": ParamDef(lead + (d, d), lead_dims + ("tp", "fsdp")),
        "ln_x": ParamDef(lead + (d,), lead_dims + (None,), init="ones"),
        "cm_mix": ParamDef(lead + (2, d), lead_dims + (None, None),
                           init="zeros"),
        "cm_k": ParamDef(lead + (d, f), lead_dims + ("fsdp", "tp")),
        "cm_v": ParamDef(lead + (f, d), lead_dims + ("tp", "fsdp")),
        "cm_r": ParamDef(lead + (d, d), lead_dims + ("fsdp", "tp")),
    }


def _mamba2_block_defs(cfg: ModelConfig, lead=()) -> Dict[str, ParamDef]:
    d = cfg.d_model
    din = cfg.expand * d
    n = cfg.ssm_state_dim
    h = din // cfg.ssm_head_dim
    w = cfg.conv_width
    lead_dims = (None,) * len(lead)
    return {
        "ln": ParamDef(lead + (d,), lead_dims + (None,), init="ones"),
        "wz": ParamDef(lead + (d, din), lead_dims + ("fsdp", "tp")),
        "wx": ParamDef(lead + (d, din), lead_dims + ("fsdp", "tp")),
        "wB": ParamDef(lead + (d, n), lead_dims + ("fsdp", None)),
        "wC": ParamDef(lead + (d, n), lead_dims + ("fsdp", None)),
        "wdt": ParamDef(lead + (d, h), lead_dims + ("fsdp", None)),
        "conv_w": ParamDef(lead + (w, din), lead_dims + (None, "tp")),
        "conv_b": ParamDef(lead + (din,), lead_dims + ("tp",), init="zeros"),
        "a_log": ParamDef(lead + (h,), lead_dims + (None,), init="zeros"),
        "d_skip": ParamDef(lead + (h,), lead_dims + (None,), init="ones"),
        "dt_bias": ParamDef(lead + (h,), lead_dims + (None,), init="zeros"),
        "gn": ParamDef(lead + (din,), lead_dims + ("tp",), init="ones"),
        "wo": ParamDef(lead + (din, d), lead_dims + ("tp", "fsdp")),
    }


def param_defs(cfg: ModelConfig) -> Dict[str, Any]:
    d, v, l = cfg.d_model, cfg.vocab_size, cfg.num_layers
    defs: Dict[str, Any] = {"final_ln": ParamDef((d,), (None,), init="ones")}
    if cfg.family == "audio":
        c = cfg.num_codebooks
        defs["codebook_embed"] = ParamDef((c, v, d), (None, "tp", "fsdp"),
                                          scale=0.02)
        defs["lm_head"] = ParamDef((c, d, v), (None, "fsdp", "tp"))
    else:
        defs["embed"] = ParamDef((v, d), ("tp", "fsdp"), scale=0.02)
        defs["lm_head"] = ParamDef((d, v), ("fsdp", "tp"))
    if cfg.family == "vlm":
        defs["vision_proj"] = ParamDef((cfg.vision_patch_dim, d),
                                       (None, "fsdp"))
    if cfg.family == "rwkv":
        defs["blocks"] = _rwkv_block_defs(cfg, lead=(l,))
    elif cfg.family == "hybrid":
        g = l // cfg.shared_attn_every
        k = cfg.shared_attn_every
        defs["mamba"] = _mamba2_block_defs(cfg, lead=(g, k))
        defs["shared"] = {**_attn_defs(cfg), **_mlp_defs(cfg)}
    else:  # dense / moe / vlm / audio transformer
        defs["blocks"] = {**_attn_defs(cfg, lead=(l,)),
                          **_mlp_defs(cfg, lead=(l,))}
    return defs


def param_shapes(cfg: ModelConfig, dtype=torch.float32) -> Dict[str, Any]:
    """The parameter tree as ``meta`` tensors (JAX returns
    ``ShapeDtypeStruct``s)."""
    def build(node):
        if isinstance(node, ParamDef):
            return torch.empty(node.shape, dtype=dtype, device="meta")
        return {k: build(v) for k, v in node.items()}

    return build(param_defs(cfg))


def _init_leaf(pd: ParamDef, gen: torch.Generator, dtype, device,
               lead: int) -> torch.Tensor:
    if pd.init == "zeros":
        return torch.zeros(pd.shape, dtype=dtype, device=device)
    if pd.init == "ones":
        return torch.ones(pd.shape, dtype=dtype, device=device)
    scale = pd.scale if pd.scale > 0 else 1.0 / np.sqrt(max(pd.fan_in(), 1))
    out = torch.empty(pd.shape, dtype=dtype, device=device)
    for part in (out.flatten(0, lead - 1).unbind(0) if lead else (out,)):
        draw = torch.randn(part.shape, generator=gen, dtype=torch.float32,
                           device=device)
        part.copy_(draw.mul_(scale))
        del draw
    return out


def init_params(cfg: ModelConfig, generator: torch.Generator,
                dtype=torch.float32, device="cuda") -> Dict[str, Any]:
    """Weights for ``cfg`` on ``device``, drawn from ``generator``.

    ``generator`` must live on ``device``'s type (``torch.Generator(device=
    ...)``).  Normal leaves are N(0, 1) * scale drawn in float32 and cast to
    ``dtype``; layer-stacked leaves are drawn one layer at a time (one
    (g, k) slice at a time for the hybrid's Mamba2 blocks).
    """
    defs = param_defs(cfg)
    dev = torch.device(device)

    def build(node, lead):
        if isinstance(node, ParamDef):
            return _init_leaf(node, generator, dtype, dev, lead)
        return {k: build(v, lead or _STACKED.get(k, 0))
                for k, v in node.items()}

    return build(defs, 0)
