"""zamba2-2.7b — Mamba2 backbone + shared attention blocks [arXiv:2411.15242; hf].

54L d_model=2560 32H (kv=32) d_ff=10240 vocab=32000, ssm_state=64.
Every 6 Mamba2 layers, ONE shared attention+MLP block (weights reused across
all 9 invocations) is applied — the Zamba2 weight-sharing trick.  Hybrid =>
sub-quadratic; runs long_500k with (SSM state + small shared-attn KV).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    d_ff=10240,
    vocab_size=32000,
    ssm_state_dim=64,
    ssm_head_dim=64,
    expand=2,
    shared_attn_every=6,
    subquadratic=True,
)
