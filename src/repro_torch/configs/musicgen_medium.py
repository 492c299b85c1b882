"""musicgen-medium — decoder-only over EnCodec tokens [arXiv:2306.05284; hf].

48L d_model=1536 24H (MHA kv=24) d_ff=6144 vocab=2048, 4 codebooks.
The EnCodec frontend is a stub: inputs are the 4 parallel token streams
(B, S, 4); per-codebook embeddings are summed, and 4 output heads predict the
next frame's codebook tokens.  MLP is GeLU (standard transformer decoder).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    num_codebooks=4,
    mlp_type="gelu",
    attention_bias=False,
)
