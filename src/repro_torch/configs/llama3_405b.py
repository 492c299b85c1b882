"""llama3-405b — dense GQA, 128k vocab [arXiv:2407.21783; unverified].

126L d_model=16384 128H (GQA kv=8) d_ff=53248 vocab=128256.

Training-memory posture on v5e (16 GB HBM): optimizer moments are int8 with
per-tensor scales (8-bit Adam) and gradients accumulate in bf16 — at 405B
params over a 256-chip pod the fp32-moment footprint alone (12.7 GB/chip)
would not leave room for activations.  See EXPERIMENTS.md §Dry-run.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b",
    family="dense",
    num_layers=126,
    d_model=16384,
    num_heads=128,
    num_kv_heads=8,
    d_ff=53248,
    vocab_size=128256,
    rope_theta=5e5,
    opt_moment_dtype="int8",
)
