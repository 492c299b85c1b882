"""Training: AdamW with fp32/bf16/int8 moments and the microbatched step."""
from repro_torch.train import optimizer, train_step

__all__ = ["optimizer", "train_step"]
