"""Train step builder: microbatched gradient accumulation and the AdamW
update, on one device.

Mirrors ``repro/train/train_step.py``.  The returned step has signature
``(params, opt_state, batch) -> (params, opt_state, metrics)``; it updates
the float32 masters and the moments in place (JAX donates them) and
returns them.  Gradients are taken with respect to the bfloat16 compute
copy, as in JAX, and accumulated in ``recipe.grad_dtype`` over the
microbatches in order.  JAX's ``lax.scan`` and unrolled accumulation add
in the same order, so one Python loop serves both
(``recipe.unroll_microbatches`` has no effect here).

The pod-axis int8 gradient compression needs a mesh, which the port does
not have yet: ``make_train_step`` refuses one.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import Recipe, ShardingCtx
from repro_torch.models import model as model_mod
from repro_torch.models.params import _STACKED
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.optimizer import layer_slices, map_tree

__all__ = ["make_train_step", "split_microbatches", "init_opt_state"]


def _batch_axis(key: str) -> int:
    return 1 if key == "positions_3d" else 0


def split_microbatches(batch: Dict[str, Any], mb: int) -> Dict[str, Any]:
    """Reshape each input so dim 0 indexes the microbatch (microbatch i
    holds rows [i*b/mb, (i+1)*b/mb) of the batch axis)."""
    out = {}
    for k, x in batch.items():
        ax = _batch_axis(k)
        b = x.shape[ax]
        if b % mb:
            raise ValueError(f"batch {k!r} of {b} rows does not split into "
                             f"{mb} microbatches")
        x = x.reshape(x.shape[:ax] + (mb, b // mb) + x.shape[ax + 1:])
        out[k] = torch.movedim(x, ax, 0)
    return out


def _cast_compute(params, cfg: ModelConfig):
    """Mixed precision: float32 masters compute in bfloat16."""
    if cfg.dtype != "bfloat16":
        return params
    return map_tree(lambda p: p.to(torch.bfloat16)
                     if p.dtype == torch.float32 else p, params)


def _grad_leaves(params_c, acc, path=()):
    """``params_c`` as the model reads it, every layer slice of a
    layer-stacked leaf a leaf of its own (nested per-layer lists), each
    with a hook that adds its gradient, cast to the accumulator's dtype,
    into the matching slice of ``acc`` and drops it.  Per-layer leaves
    keep the backward from materialising a zero-padded full-size gradient
    for every layer's slice, and the hooks free each layer's gradients as
    soon as they are added."""
    if isinstance(params_c, dict):
        return {k: _grad_leaves(params_c[k], acc[k], path + (k,))
                for k in params_c}

    def leaf(x, a):
        x = x.detach().requires_grad_()

        def add(t):
            a.add_(t.grad.to(a.dtype))
            t.grad = None

        x.register_post_accumulate_grad_hook(add)
        return x

    flat = [leaf(x, a) for x, a in zip(layer_slices(path, params_c),
                                       layer_slices(path, acc))]
    lead = _STACKED.get(path[0], 0)
    if lead == 2:
        k = params_c.shape[1]
        return [flat[g:g + k] for g in range(0, len(flat), k)]
    return flat if lead else flat[0]


def _grads_fn(params, batch, cfg: ModelConfig, ctx: ShardingCtx):
    """Microbatched loss and gradients.

    Gradients are taken w.r.t. the bf16 COMPUTE copy of the params and
    accumulated in ``recipe.grad_dtype`` (float32 by default; bfloat16
    halves the accumulator), then divided by the microbatch count.
    """
    mb = ctx.recipe.microbatch
    gdt = (torch.bfloat16 if ctx.recipe.grad_dtype == "bfloat16"
           else torch.float32)
    acc = map_tree(lambda p: torch.zeros(p.shape, dtype=gdt,
                                          device=p.device), params)
    model_params = _grad_leaves(_cast_compute(params, cfg), acc)
    if mb <= 1:
        parts = [batch]
    else:
        split = split_microbatches(batch, mb)
        parts = [{k: v[i] for k, v in split.items()} for i in range(mb)]
    loss_sum = 0.0
    for part in parts:
        loss = model_mod.loss_fn(model_params, cfg, part, ctx)
        loss.backward()
        loss_sum = loss_sum + loss.detach()
    if mb <= 1:
        return loss_sum, acc
    inv = 1.0 / mb
    return loss_sum * inv, map_tree(lambda g: g.mul_(inv), acc)


def make_train_step(cfg: ModelConfig, recipe: Recipe, mesh,
                    opt_cfg: opt_mod.AdamWConfig):
    if mesh is not None:
        raise NotImplementedError(
            "repro_torch trains on one device; meshes (and the pod-axis "
            "gradient compression) arrive with the distributed slice")
    lr_fn = opt_mod.cosine_schedule(opt_cfg)
    ctx = ShardingCtx(None, recipe)

    def step(params, opt_state, batch):
        loss, grads = _grads_fn(params, batch, cfg, ctx)
        core = {k: opt_state[k] for k in ("m", "v", "step")}
        params, core, metrics = opt_mod.adamw_update(
            grads, core, params, opt_cfg, lr_fn)
        metrics["loss"] = loss
        return params, dict(opt_state, **core), metrics

    return step


def init_opt_state(params, cfg: ModelConfig, recipe: Recipe,
                   opt_cfg: opt_mod.AdamWConfig):
    state = opt_mod.adamw_init(params, opt_cfg)
    if recipe.compress_pod_grads:
        state["ef"] = map_tree(lambda p: torch.zeros(
            p.shape, dtype=torch.float32, device=p.device), params)
    return state
