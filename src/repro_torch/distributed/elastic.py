"""Elastic re-scaling: restore any checkpoint onto any mesh.

Mirrors ``repro/distributed/elastic.py``.  Checkpoints are
sharding-agnostic (whole arrays per key path), so scaling from N to M
devices is: restore -> rebuild the shardings for the new mesh from the same
``ParamDef`` templates -> place.  Dims that no longer divide the new axis
group fall back inside ``ShardingCtx._resolve``, so a recipe tuned for 256
ranks loads cleanly on 8 (degraded parallelism, same math).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import (Recipe, ShardingCtx, place,
                                              tree_shardings)
from repro_torch.models import params as params_mod

__all__ = ["reshard_params", "reshard_tree"]


def reshard_tree(host_tree, shardings, device="cpu"):
    """Place a host (numpy or tensor) tree: each leaf on ``device``, then
    a DTensor with its sharding's placements (a plain tensor where the
    sharding is None)."""
    if isinstance(host_tree, dict):
        return {k: reshard_tree(host_tree[k], shardings[k], device)
                for k in host_tree}
    x = torch.as_tensor(host_tree, device=device)
    return place(x, shardings)


def reshard_params(host_params: Dict[str, Any], cfg: ModelConfig,
                   mesh, recipe: Recipe, device="cpu"):
    """Place restored params onto a (possibly different) mesh, or onto
    ``device`` as plain tensors with ``mesh`` None."""
    ctx = ShardingCtx(mesh, recipe)
    defs = params_mod.param_defs(cfg)
    return reshard_tree(host_params, tree_shardings(ctx, defs), device)
