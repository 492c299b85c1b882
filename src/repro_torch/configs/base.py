"""Model/shape configuration system.

Every assigned architecture is a frozen ``ModelConfig``; input shapes are
``ShapeSpec``s.  ``reduced()`` gives the CPU-smoke-test version of any config
(same family/wiring, tiny dims).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["ModelConfig", "ShapeSpec", "SHAPES"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | rwkv | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0           # 0 -> d_model // num_heads

    # MLP
    mlp_type: str = "swiglu"    # swiglu | gelu
    attention_bias: bool = False

    # MoE
    num_experts: int = 0
    experts_per_tok: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0           # per-expert hidden dim (0 -> d_ff)
    capacity_factor: float = 1.25

    # SSM / RWKV / hybrid
    ssm_state_dim: int = 0
    ssm_head_dim: int = 64
    conv_width: int = 4
    expand: int = 2
    shared_attn_every: int = 0  # zamba2: shared attn+mlp block period
    chunk_size: int = 128       # chunked linear-attention/SSD block length

    # Modality frontends (stubs; see DESIGN.md)
    mrope: bool = False
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)
    num_vision_tokens: int = 0
    vision_patch_dim: int = 0
    num_codebooks: int = 0      # musicgen: EnCodec token streams

    rope_theta: float = 1e6
    norm_eps: float = 1e-5
    subquadratic: bool = False  # supports long_500k decode
    dtype: str = "bfloat16"

    # training-side knobs (overridable per recipe)
    opt_moment_dtype: str = "float32"   # float32 | bfloat16 | int8

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // max(self.num_heads, 1))

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    def param_count(self) -> int:
        """Approximate parameter count (used for 6ND model-FLOPs)."""
        d, f, l, v = self.d_model, self.d_ff, self.num_layers, self.vocab_size
        hd = self.head_dim
        emb = v * d * (1 + self.num_codebooks if self.num_codebooks else 1)
        out_heads = max(1, self.num_codebooks or 1) * v * d
        if self.family == "rwkv":
            per_layer = d * d * 4 + d * self.d_ff * 2 + d * 512  # tm + cm + loras
            return emb + out_heads + l * per_layer
        attn = d * (self.num_heads * hd) + 2 * d * (self.num_kv_heads * hd) \
            + (self.num_heads * hd) * d
        mlp_mult = 3 if self.mlp_type == "swiglu" else 2
        if self.is_moe:
            fe = self.moe_d_ff or f
            mlp = self.num_experts * mlp_mult * d * fe \
                + self.num_shared_experts * mlp_mult * d * fe + d * self.num_experts
        else:
            mlp = mlp_mult * d * f
        if self.family == "hybrid":
            d_in = d * self.expand
            ssm = l * (d * (2 * d_in + 2 * self.ssm_state_dim * 0 + 2) + d_in * d
                       + d_in * 2 * self.ssm_state_dim)
            n_shared = max(1, l // max(self.shared_attn_every, 1))
            return emb + out_heads + ssm + (attn + mlp)  # one shared block
        return emb + out_heads + l * (attn + mlp)

    def active_param_count(self) -> int:
        """Activated params per token (MoE: top-k + shared experts only)."""
        if not self.is_moe:
            return self.param_count()
        d, l = self.d_model, self.num_layers
        hd = self.head_dim
        fe = self.moe_d_ff or self.d_ff
        mlp_mult = 3 if self.mlp_type == "swiglu" else 2
        attn = d * (self.num_heads * hd) + 2 * d * (self.num_kv_heads * hd) \
            + (self.num_heads * hd) * d
        mlp = (self.experts_per_tok + self.num_shared_experts) * mlp_mult * d * fe \
            + d * self.num_experts
        return 2 * self.vocab_size * d + l * (attn + mlp)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}
