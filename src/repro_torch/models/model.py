"""Unified model API for the serving path: family dispatch for prefill and
decode, plus the decode cache's shapes.

Mirrors ``repro/models/model.py``; families other than ``dense`` raise
``NotImplementedError`` (from ``params.check_family``) until their slice
of the port lands.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.distributed.sharding import ShardingCtx
from repro_torch.models import transformer
from repro_torch.models.params import check_family

__all__ = ["prefill_fn", "decode_fn", "cache_specs"]


def prefill_fn(params, cfg: ModelConfig, batch, ctx: ShardingCtx):
    return transformer.transformer_prefill(params, cfg, batch, ctx)


def decode_fn(params, cfg: ModelConfig, batch, cache, ctx: ShardingCtx):
    return transformer.transformer_decode(params, cfg, batch, cache, ctx)


def cache_specs(cfg: ModelConfig, shape: ShapeSpec,
                kv_dtype=torch.bfloat16) -> Optional[Dict[str, Any]]:
    """The decode cache of ``shape`` as ``meta`` tensors (None otherwise)."""
    if shape.kind != "decode":
        return None
    check_family(cfg)
    return transformer.init_kv_cache(cfg, shape.global_batch, shape.seq_len,
                                     kv_dtype)
