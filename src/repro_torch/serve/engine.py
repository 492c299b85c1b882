"""Batched serving engine: prefill + greedy decode loop over the unified
model API, in eager PyTorch on one explicit device (the card by default)
or on a ``DeviceMesh``.

Mirrors ``repro/serve/engine.py``.  The decode cache is allocated once at
``max_seq``; the prefill's K/V are spliced into its leading positions, and
its recurrent states (RWKV, Mamba2) replace the cache's, by JAX's rule
(``_splice_prefill``).  A transformer step writes its K/V in place; the
recurrent families' steps return new state leaves, as in JAX.

The cache holds ``recipe.kv_cache_dtype`` (bfloat16 or int8); an int8
cache gets the prefill's K/V quantized per (token, head) by the decode
step's own rule.  JAX's engine always allocates bfloat16.

On a mesh (``mesh=DeviceMesh``, whose dim names are the JAX axes) the
engine does what JAX's does with ``ShardingCtx(mesh, recipe)``: params
are placed by their shardings (``tree_shardings``) unless they already
are DTensors, the empty cache is made on the mesh by the cache's
shardings (the default ``kv_seq_axes=("model",)`` splits its length),
tokens and lengths are split by batch, and each step's logits are
gathered whole before the argmax.  The tokens come back as numpy on
every rank, as without a mesh.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.core.session import DEFAULT_TORCH_DEVICE, resolve_torch_device
from repro_torch.distributed.sharding import (Recipe, ShardingCtx,
                                              from_shard, is_dtensor, place,
                                              tree_shardings)
from repro_torch.models import model as model_mod
from repro_torch.models import params as params_mod
from repro_torch.models.transformer import _quantize_kv

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
            from torch.distributed.device_mesh import DeviceMesh
            if not isinstance(mesh, DeviceMesh):
                raise TypeError(f"mesh must be a torch.distributed "
                                f"DeviceMesh, got {type(mesh).__name__}")
        self.cfg = cfg
        self.ctx = ShardingCtx(mesh, recipe)
        self.max_seq = max_seq
        self.device = resolve_torch_device(device)
        if mesh is not None and mesh.device_type != self.device.type:
            raise ValueError(f"the mesh is on {mesh.device_type}, the "
                             f"engine's device is {self.device}")
        self.params = params if mesh is None else _place_tree(
            params, tree_shardings(self.ctx, params_mod.param_defs(cfg)))
        self.kv_dtype = (torch.int8 if recipe.kv_cache_dtype == "int8"
                         else torch.bfloat16)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _empty_cache(self, batch: int):
        shape = ShapeSpec("serve", "decode", self.max_seq, batch)
        specs = model_mod.cache_specs(self.cfg, shape, self.kv_dtype)
        if self.ctx.mesh is None:
            return {n: torch.zeros(s.shape, dtype=s.dtype, device=self.device)
                    for n, s in specs.items()}
        from torch.distributed.tensor import zeros
        dims = model_mod.cache_dims(self.cfg)
        return {n: zeros(s.shape, dtype=s.dtype, device_mesh=self.ctx.mesh,
                         placements=self.ctx.sharding(s.shape,
                                                      dims[n]).placements)
                for n, s in specs.items()}

    def _rows(self, x):
        """A (B, ...) input split by batch on a mesh, as ``input_dims``
        gives it."""
        return self.ctx.constrain(x, "batch", *(None,) * (x.dim() - 1))

    @staticmethod
    def _whole(logits):
        """Logits whole on every rank (a mesh may split the vocabulary), so
        ``torch.argmax`` takes the first index of a tie, as ``jnp.argmax``
        does."""
        return logits.full_tensor() if is_dtensor(logits) else logits

    def generate(self, prompts: np.ndarray, max_new_tokens: int = 16
                 ) -> GenerationResult:
        """prompts: (B, S0) int32 (audio: (B, S0, C)). Greedy decoding."""
        # DTensor ops index their inputs as views, which inference tensors
        # refuse: a mesh serves under no_grad
        with (torch.inference_mode() if self.ctx.mesh is None
              else torch.no_grad()):
            return self._generate(prompts, max_new_tokens)

    def _generate(self, prompts, max_new_tokens):
        b, s0 = prompts.shape[:2]
        if s0 + max_new_tokens > self.max_seq:
            raise ValueError(f"prompt {s0} + {max_new_tokens} new tokens "
                             f"exceed max_seq {self.max_seq}")
        tokens = torch.as_tensor(np.asarray(prompts, np.int64),
                                 device=self.device)
        t0 = time.perf_counter()
        logits, prefill_cache = model_mod.prefill_fn(
            self.params, self.cfg, {"tokens": self._rows(tokens)}, self.ctx)
        self._sync()
        t_prefill = time.perf_counter() - t0

        cache = _splice_prefill(self._empty_cache(b), prefill_cache)
        del prefill_cache
        lengths = torch.full((b,), s0, dtype=torch.int32, device=self.device)
        logits = self._whole(logits)
        next_tok = torch.argmax(logits, dim=-1)               # (B[,C])

        out = [tokens]
        t0 = time.perf_counter()
        for _ in range(max_new_tokens):
            tok = next_tok[:, None]                           # (B,1[,C])
            out.append(tok)
            step_logits, cache = model_mod.decode_fn(
                self.params, self.cfg,
                {"tokens": self._rows(tok), "lengths": self._rows(lengths)},
                cache, self.ctx)
            lengths = lengths + 1
            next_tok = torch.argmax(self._whole(step_logits), dim=-1)
        self._sync()
        t_decode = time.perf_counter() - t0
        toks = torch.cat(out, dim=1).cpu().numpy().astype(np.int32)
        return GenerationResult(toks, t_prefill, t_decode, max_new_tokens,
                                logits)


def _place_tree(tree, shardings):
    """``tree``'s leaves placed by ``shardings``; a DTensor leaf is kept as
    it is."""
    if isinstance(tree, dict):
        return {k: _place_tree(v, shardings[k]) for k, v in tree.items()}
    return tree if is_dtensor(tree) else place(tree, shardings)


def _splice_prefill(cache, prefill_cache):
    """Copy prefill KV/state into the (larger) decode cache buffers: a
    leaf that differs from its buffer in shape (the sequence-extended KV)
    is written into the buffer's leading slice; any other leaf replaces
    its buffer, cast to the buffer's type (and, on a mesh, laid out as
    the buffer).  An int8 buffer takes the prefill's K/V quantized, with
    their scales."""
    if "k_scale" in cache and "k_scale" not in prefill_cache:
        prefill_cache = dict(prefill_cache)
        for name in ("k", "v"):
            prefill_cache[name], prefill_cache[name + "_scale"] = \
                _quantize_kv(prefill_cache[name])
    out = {}
    for name, dst in cache.items():
        src = prefill_cache[name]
        if dst.dim() >= 3 and src.dim() == dst.dim() \
                and src.shape != dst.shape:
            out[name] = _splice_leading(dst, src)
        elif is_dtensor(dst):
            out[name] = src.to(dst.dtype).redistribute(dst.device_mesh,
                                                       dst.placements)
        else:
            out[name] = src.to(dst.dtype)
    return out


def _splice_leading(dst, src):
    """``dst`` with ``src`` written into its leading slice, in place.  On
    a mesh each rank writes its own shard: ``src`` is laid out as ``dst``
    except along the dims where the two differ in size (there whole), and
    this rank's part of those dims is cut from it (``DTensor``'s own
    ``__setitem__`` does not split a slice of a split dim)."""
    if not is_dtensor(dst):
        dst[tuple(slice(0, n) for n in src.shape)] = src
        return dst
    from torch.distributed.tensor import Replicate, Shard
    mesh, pl = dst.device_mesh, dst.placements
    grown = {d for d in range(dst.dim()) if src.shape[d] != dst.shape[d]}
    want = [Replicate() if isinstance(p, Shard) and p.dim in grown else p
            for p in pl]
    part = src.redistribute(mesh, want).to_local()
    loc = dst.to_local()
    coord = mesh.get_coordinate()
    index = []
    for d in range(dst.dim()):
        if d not in grown:
            index.append((slice(None), slice(None)))
            continue
        # this rank's chunk of dim d, major to minor over the mesh dims
        # that split it (evenly: a spec splits only what divides)
        chunk = 0
        for i, p in enumerate(pl):
            if p == Shard(d):
                chunk = chunk * mesh.size(i) + coord[i]
        start = chunk * loc.shape[d]
        stop = min(start + loc.shape[d], src.shape[d])
        if stop <= start:
            return dst                      # this shard lies past the prompt
        index.append((slice(0, stop - start), slice(start, stop)))
    loc[tuple(i for i, _ in index)] = \
        part[tuple(j for _, j in index)].to(loc.dtype)
    return from_shard(loc, mesh, pl, dst.shape)
