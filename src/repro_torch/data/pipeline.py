"""Deterministic LM token pipeline: sharded, resumable, elastic.

Batches are a pure function of (seed, step) — counter-based generation, no
iterator state — so failure replay (Supervisor) and elastic re-scaling resume
exactly without data loss or duplication.  On a real cluster each host slices
its batch shard by process index from the same function.

The stream is synthetic zipf-mixture tokens (this container has no corpus);
a tokenized corpus would keep the same step->batch contract via an index
file, which is the property fault tolerance actually relies on.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

__all__ = ["TokenPipeline"]


@dataclasses.dataclass(frozen=True)
class TokenPipeline:
    vocab_size: int
    global_batch: int
    seq_len: int
    seed: int = 0
    num_codebooks: int = 0       # audio family
    vlm_tokens: int = 0          # vision slots (vlm family)
    patch_dim: int = 0

    def batch_for_step(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, step))
        shape = (self.global_batch, self.seq_len + 1)
        if self.num_codebooks:
            shape = shape + (self.num_codebooks,)
        # zipf head + uniform tail mixture, clipped to vocab
        z = rng.zipf(1.4, size=shape)
        u = rng.integers(0, self.vocab_size, size=shape)
        pick = rng.random(shape) < 0.5
        tokens = np.where(pick, np.minimum(z, self.vocab_size - 1), u)
        batch = {"tokens": tokens.astype(np.int32)}
        if self.vlm_tokens:
            batch["vision_embeds"] = rng.standard_normal(
                (self.global_batch, self.vlm_tokens, self.patch_dim)
            ).astype(np.float32)
            batch["positions_3d"] = np.broadcast_to(
                np.arange(self.seq_len, dtype=np.int32)[None, None],
                (3, self.global_batch, self.seq_len)).copy()
        return batch

    def host_shard(self, batch: Dict[str, np.ndarray], process_index: int,
                   process_count: int) -> Dict[str, np.ndarray]:
        """Slice the per-host shard (multi-host clusters)."""
        out = {}
        for k, v in batch.items():
            ax = 1 if k == "positions_3d" else 0
            n = v.shape[ax] // process_count
            sl = [slice(None)] * v.ndim
            sl[ax] = slice(process_index * n, (process_index + 1) * n)
            out[k] = v[tuple(sl)]
        return out
