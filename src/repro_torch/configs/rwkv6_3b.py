"""rwkv6-3b (Finch) — attention-free, data-dependent decay [arXiv:2404.05892; hf].

32L d_model=2560 d_ff=8960 vocab=65536.  40 heads of dim 64; matrix-valued
state (H, 64, 64) per layer.  Sub-quadratic: runs the long_500k decode shape.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="rwkv",
    num_layers=32,
    d_model=2560,
    num_heads=40,         # d_model / ssm_head_dim
    num_kv_heads=40,
    d_ff=8960,
    vocab_size=65536,
    head_dim=64,
    ssm_head_dim=64,
    subquadratic=True,
)
