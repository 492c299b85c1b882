"""phi3.5-moe-42b-a6.6b — 16-expert top-2 MoE
[hf:microsoft/Phi-3.5-MoE-instruct; hf].

32L d_model=4096 32H (GQA kv=8) d_ff=6400 vocab=32064, 16 experts top-2.
Experts shard 1-per-device over the 16-way model axis (EP).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=6400,
    vocab_size=32064,
    num_experts=16,
    experts_per_tok=2,
    moe_d_ff=6400,
)
