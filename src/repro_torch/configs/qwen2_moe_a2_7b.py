"""qwen2-moe-a2.7b — 60 routed experts top-4 + 4 shared experts
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf].

24L d_model=2048 16H (GQA kv=16) per-expert d_ff=1408 vocab=151936.
Routed experts are padded 60 -> 64 for even EP over the 16-way model axis
(4 experts per device); the 4 shared experts always fire.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=151936,
    num_experts=60,
    experts_per_tok=4,
    num_shared_experts=4,
    moe_d_ff=1408,
)
