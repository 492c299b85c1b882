"""Architecture registry: ``--arch <id>`` resolves here."""
from __future__ import annotations

import dataclasses

from repro_torch.configs import (
    base,
    command_r_35b,
    llama3_405b,
    musicgen_medium,
    phi35_moe,
    qwen2_moe_a2_7b,
    qwen2_vl_7b,
    rwkv6_3b,
    starcoder2_3b,
    yi_34b,
    zamba2_2_7b,
)
from repro_torch.configs.base import SHAPES, ModelConfig, ShapeSpec

ARCHS = {
    "qwen2-vl-7b": qwen2_vl_7b.CONFIG,
    "yi-34b": yi_34b.CONFIG,
    "llama3-405b": llama3_405b.CONFIG,
    "command-r-35b": command_r_35b.CONFIG,
    "starcoder2-3b": starcoder2_3b.CONFIG,
    "rwkv6-3b": rwkv6_3b.CONFIG,
    "musicgen-medium": musicgen_medium.CONFIG,
    "zamba2-2.7b": zamba2_2_7b.CONFIG,
    "phi3.5-moe-42b-a6.6b": phi35_moe.CONFIG,
    "qwen2-moe-a2.7b": qwen2_moe_a2_7b.CONFIG,
}


def get_config(arch: str) -> ModelConfig:
    try:
        return ARCHS[arch]
    except KeyError:
        raise ValueError(f"unknown arch {arch!r}; one of {sorted(ARCHS)}") from None


def reduced(cfg: ModelConfig, seq_hint: int = 128) -> ModelConfig:
    """Family-preserving tiny config for CPU smoke tests."""
    kw = dict(
        num_layers=4 if cfg.family == "hybrid" else 2,
        d_model=128,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 2) if cfg.num_kv_heads < cfg.num_heads else 4,
        d_ff=256,
        vocab_size=512,
        head_dim=32,
        chunk_size=32,
    )
    if cfg.is_moe:
        kw.update(num_experts=4, experts_per_tok=2, moe_d_ff=64,
                  num_shared_experts=min(cfg.num_shared_experts, 1))
    if cfg.family in ("rwkv", "hybrid"):
        kw.update(ssm_head_dim=16, head_dim=16, num_heads=8, num_kv_heads=8,
                  ssm_state_dim=min(cfg.ssm_state_dim, 16) or 0)
    if cfg.family == "hybrid":
        kw.update(shared_attn_every=2)
    if cfg.family == "vlm":
        kw.update(num_vision_tokens=8, vision_patch_dim=48, mrope_sections=(4, 6, 6))
    return dataclasses.replace(cfg, **kw)


__all__ = ["ARCHS", "SHAPES", "ModelConfig", "ShapeSpec", "get_config", "reduced", "base"]
