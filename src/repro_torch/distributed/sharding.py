"""Recipes, parameter definitions and the sharding context, on one device.

Mirrors ``repro/distributed/sharding.py``: a ``Recipe`` carries the
distribution and implementation knobs (``attn_impl``, ``block_kv``, ``remat``
and the mesh-axis roles), a ``ParamDef`` the shape, logical roles and
initializer of one parameter, and a ``ShardingCtx`` threads (mesh, recipe)
through model code.  Only the single-device context exists here: a mesh is
refused, and ``constrain`` returns its input, which is what the JAX context
does when its mesh is ``None``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["Recipe", "ParamDef", "ShardingCtx"]


@dataclasses.dataclass(frozen=True)
class Recipe:
    """Distribution recipe — the same fields and defaults as the JAX one."""

    batch_axes: Tuple[str, ...] = ("data",)
    fsdp_axes: Tuple[str, ...] = ("data",)
    tp_axes: Tuple[str, ...] = ("model",)
    ep_axes: Tuple[str, ...] = ("model",)
    seq_axes: Tuple[str, ...] = ()
    act_embed_axes: Tuple[str, ...] = ()
    kv_batch_axes: Optional[Tuple[str, ...]] = None
    kv_seq_axes: Tuple[str, ...] = ("model",)
    remat: str = "block"                      # none | block | nested
    microbatch: int = 1
    grad_dtype: str = "float32"
    kv_cache_dtype: str = "bfloat16"          # bfloat16 | int8 (decode cache)
    param_dtype: str = "float32"
    unroll_microbatches: bool = False
    attn_impl: str = "blockwise"              # blockwise | dense | pallas
    block_kv: int = 1024
    compress_pod_grads: bool = False
    moment_dtype: Optional[str] = None
    scan_layers: bool = True


@dataclasses.dataclass(frozen=True)
class ParamDef:
    """Shape + logical roles + initializer for one parameter tensor."""

    shape: Tuple[int, ...]
    dims: Tuple[Optional[str], ...]     # role per dim ("fsdp"/"tp"/"ep"/None)
    init: str = "normal"                # normal | zeros | ones
    scale: float = -1.0                 # -1 -> 1/sqrt(fan_in) heuristic

    def fan_in(self) -> int:
        return self.shape[-2] if len(self.shape) >= 2 else self.shape[-1]


class ShardingCtx:
    """Threads (mesh, recipe) through model code on a single device."""

    def __init__(self, mesh=None, recipe: Recipe = Recipe()):
        if mesh is not None:
            raise NotImplementedError(
                "repro_torch runs the models on one device; meshes arrive "
                "with the distributed slice of the port")
        self.mesh = None
        self.recipe = recipe

    def constrain(self, x, *dims):
        """No mesh, no constraint: ``x`` unchanged."""
        return x
