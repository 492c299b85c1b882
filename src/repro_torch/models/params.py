"""Parameter templates and initialization for the dense transformer family.

Mirrors ``repro/models/params.py``: ``param_defs`` builds the nested dict of
:class:`ParamDef` (layer-stacked leaves carry a leading L dim, the same keys
and layout as the JAX pytree, so ``convert.params_from_jax`` maps one onto
the other), and ``init_params`` draws the weights.

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

__all__ = ["param_defs", "init_params", "check_family"]

_FAMILIES = ("dense",)


def check_family(cfg: ModelConfig) -> None:
    """Raise unless ``cfg``'s family has been ported."""
    if cfg.family not in _FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported yet (the "
            "port serves the dense transformer family; MoE, RWKV, Mamba2/"
            "hybrid, VLM and audio come in a later slice)")


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
    if cfg.mlp_type == "swiglu":
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


def param_defs(cfg: ModelConfig) -> Dict[str, Any]:
    check_family(cfg)
    d, v, l = cfg.d_model, cfg.vocab_size, cfg.num_layers
    return {
        "final_ln": ParamDef((d,), (None,), init="ones"),
        "embed": ParamDef((v, d), ("tp", "fsdp"), scale=0.02),
        "lm_head": ParamDef((d, v), ("fsdp", "tp")),
        "blocks": {**_attn_defs(cfg, lead=(l,)), **_mlp_defs(cfg, lead=(l,))},
    }


def _init_leaf(pd: ParamDef, gen: torch.Generator, dtype, device,
               stacked: bool) -> torch.Tensor:
    if pd.init == "zeros":
        return torch.zeros(pd.shape, dtype=dtype, device=device)
    if pd.init == "ones":
        return torch.ones(pd.shape, dtype=dtype, device=device)
    scale = pd.scale if pd.scale > 0 else 1.0 / np.sqrt(max(pd.fan_in(), 1))
    out = torch.empty(pd.shape, dtype=dtype, device=device)
    for part in (out.unbind(0) if stacked else (out,)):
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
    ``dtype``; layer-stacked leaves are drawn one layer at a time.
    """
    defs = param_defs(cfg)
    dev = torch.device(device)

    def build(node, stacked):
        if isinstance(node, ParamDef):
            return _init_leaf(node, generator, dtype, dev, stacked)
        return {k: build(v, stacked or k == "blocks")
                for k, v in node.items()}

    return build(defs, False)
