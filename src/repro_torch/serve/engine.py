"""Batched serving engine: prefill + greedy decode loop over the unified
model API, in eager PyTorch on one explicit device (the card by default).

Mirrors ``repro/serve/engine.py``.  The decode cache is allocated once at
``max_seq``; the prefill's K/V are spliced into its leading positions, and
its recurrent states (RWKV, Mamba2) replace the cache's, by JAX's rule
(``_splice_prefill``).  A transformer step writes its K/V in place; the
recurrent families' steps return new state leaves, as in JAX.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.core.session import DEFAULT_TORCH_DEVICE, resolve_torch_device
from repro_torch.distributed.sharding import Recipe, ShardingCtx
from repro_torch.models import model as model_mod

__all__ = ["ServeEngine", "GenerationResult"]


@dataclasses.dataclass
class GenerationResult:
    tokens: np.ndarray             # (B, prompt + generated)
    prefill_seconds: float
    decode_seconds: float
    steps: int
    prefill_logits: torch.Tensor   # (B, V) float32 last-token logits


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params, mesh=None,
                 recipe: Recipe = Recipe(remat="none"), max_seq: int = 512,
                 device=DEFAULT_TORCH_DEVICE):
        if mesh is not None:
            raise NotImplementedError(
                "ServeEngine serves on one device: serving on a mesh "
                "(DTensor params and caches through the attention kernels) "
                "is not ported; the mesh layer trains and dry-runs cells")
        self.cfg = cfg
        self.params = params
        self.ctx = ShardingCtx(mesh, recipe)
        self.max_seq = max_seq
        self.device = resolve_torch_device(device)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _empty_cache(self, batch: int):
        shape = ShapeSpec("serve", "decode", self.max_seq, batch)
        specs = model_mod.cache_specs(self.cfg, shape)
        return {n: torch.zeros(s.shape, dtype=s.dtype, device=self.device)
                for n, s in specs.items()}

    @torch.inference_mode()
    def generate(self, prompts: np.ndarray, max_new_tokens: int = 16
                 ) -> GenerationResult:
        """prompts: (B, S0) int32 (audio: (B, S0, C)). Greedy decoding."""
        b, s0 = prompts.shape[:2]
        if s0 + max_new_tokens > self.max_seq:
            raise ValueError(f"prompt {s0} + {max_new_tokens} new tokens "
                             f"exceed max_seq {self.max_seq}")
        tokens = torch.as_tensor(np.asarray(prompts, np.int64),
                                 device=self.device)
        t0 = time.perf_counter()
        logits, prefill_cache = model_mod.prefill_fn(
            self.params, self.cfg, {"tokens": tokens}, self.ctx)
        self._sync()
        t_prefill = time.perf_counter() - t0

        cache = _splice_prefill(self._empty_cache(b), prefill_cache)
        del prefill_cache
        lengths = torch.full((b,), s0, dtype=torch.int32, device=self.device)
        next_tok = torch.argmax(logits, dim=-1)               # (B[,C])

        out = [tokens]
        t0 = time.perf_counter()
        for _ in range(max_new_tokens):
            tok = next_tok[:, None]                           # (B,1[,C])
            out.append(tok)
            step_logits, cache = model_mod.decode_fn(
                self.params, self.cfg, {"tokens": tok, "lengths": lengths},
                cache, self.ctx)
            lengths = lengths + 1
            next_tok = torch.argmax(step_logits, dim=-1)
        self._sync()
        t_decode = time.perf_counter() - t0
        toks = torch.cat(out, dim=1).cpu().numpy().astype(np.int32)
        return GenerationResult(toks, t_prefill, t_decode, max_new_tokens,
                                logits)


def _splice_prefill(cache, prefill_cache):
    """Copy prefill KV/state into the (larger) decode cache buffers: a
    leaf that differs from its buffer in shape (the sequence-extended KV)
    is written into the buffer's leading slice; any other leaf replaces
    its buffer, cast to the buffer's type."""
    out = {}
    for name, dst in cache.items():
        src = prefill_cache[name]
        if dst.dim() >= 3 and src.dim() == dst.dim() \
                and src.shape != dst.shape:
            dst[tuple(slice(0, n) for n in src.shape)] = src
            out[name] = dst
        else:
            out[name] = src.to(dst.dtype)
    return out
