"""qwen2-vl-7b — M-RoPE VLM backbone [arXiv:2409.12191; hf].

28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064.  The dynamic-
resolution vision tower is a stub: ``input_specs`` provides precomputed patch
embeddings (B, num_vision_tokens, patch_dim) that a linear merger projects
into the first ``num_vision_tokens`` sequence slots; M-RoPE (t/h/w sections
16/24/24 over the half-dim) comes in as 3-channel position ids.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    family="vlm",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    d_ff=18944,
    vocab_size=152064,
    mrope=True,
    mrope_sections=(16, 24, 24),
    num_vision_tokens=256,
    vision_patch_dim=1176,
    rope_theta=1e6,
)
