"""Train step builder: microbatched gradient accumulation and the AdamW
update, on one device or a mesh.

Mirrors ``repro/train/train_step.py``.  The returned step has signature
``(params, opt_state, batch) -> (params, opt_state, metrics)``; it updates
the float32 masters and the moments in place (JAX donates them) and
returns them.  Gradients are taken with respect to the bfloat16 compute
copy, as in JAX, and accumulated in ``recipe.grad_dtype`` over the
microbatches in order.  JAX's ``lax.scan`` and unrolled accumulation add
in the same order, so one Python loop serves both
(``recipe.unroll_microbatches`` has no effect here).

With a mesh (a ``DeviceMesh`` named by the recipe's axes) the step runs on
DTensor params, moments and batch: a plain batch is placed by its
``ShardingCtx`` roles first, and :func:`shard_state` places a plain state
(a checkpoint's arrays; ``launch.train.build_trainer`` calls it).  With ``recipe.compress_pod_grads`` and a
"pod" axis, JAX's ``shard_map`` over "pod" becomes: the params live on the
(data, model) sub-mesh of each pod under the recipe with "pod" stripped,
each pod takes its slice of the batch, and the gradients go through
``compression.compressed_pod_mean`` (int8 payloads gathered over the pod
group, error feedback ``ef`` carried in the optimizer state) before AdamW.
"""
from __future__ import annotations

from typing import Any, Dict

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import compression
from repro_torch.distributed.sharding import (Recipe, ShardingCtx,
                                              is_dtensor, place,
                                              tree_shardings)
from repro_torch.models import model as model_mod
from repro_torch.models import params as params_mod
from repro_torch.models.params import _STACKED
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.optimizer import layer_slices, map_tree

__all__ = ["make_train_step", "split_microbatches", "init_opt_state",
           "param_ctx", "state_shardings", "shard_state"]


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
    acc = map_tree(lambda p: torch.zeros_like(p, dtype=gdt), params)
    model_params = _grad_leaves(_cast_compute(params, cfg), acc)
    if mb <= 1:
        parts = [batch]
    else:
        if ctx.mesh is not None:
            # microbatch i is the batch's i-th block of rows, as in JAX:
            # whole on every rank, then each block sharded again
            batch = {k: _replicated(v) for k, v in batch.items()}
        split = split_microbatches(batch, mb)
        parts = [{k: ctx.constrain(v[i], *_batch_dims(k, v[i]))
                  for k, v in split.items()} for i in range(mb)]
    loss_sum = 0.0
    for part in parts:
        with ctx.scope():          # the backward meets the same tensors
            loss = model_mod.loss_fn(model_params, cfg, part, ctx)
            loss.backward()
        loss_sum = loss_sum + loss.detach()
    if mb <= 1:
        return loss_sum, acc
    inv = 1.0 / mb
    return loss_sum * inv, map_tree(lambda g: g.mul_(inv), acc)


def _strip_pod(recipe: Recipe) -> Recipe:
    """The recipe inside one pod: its roles on the remaining axes only."""
    f = lambda axes: tuple(a for a in axes if a != "pod")
    return dataclasses.replace(
        recipe,
        batch_axes=f(recipe.batch_axes), fsdp_axes=f(recipe.fsdp_axes),
        tp_axes=f(recipe.tp_axes), ep_axes=f(recipe.ep_axes),
        seq_axes=f(recipe.seq_axes), act_embed_axes=f(recipe.act_embed_axes),
        kv_batch_axes=(f(recipe.kv_batch_axes)
                       if recipe.kv_batch_axes is not None else None),
        kv_seq_axes=f(recipe.kv_seq_axes))


def _compresses(recipe: Recipe, mesh) -> bool:
    return bool(recipe.compress_pod_grads and mesh is not None
                and "pod" in mesh.mesh_dim_names)


def param_ctx(recipe: Recipe, mesh) -> ShardingCtx:
    """The context the step's model and state live under: ``mesh`` and
    ``recipe``, or with pod compression each pod's (data, model) sub-mesh
    and the recipe with "pod" stripped (JAX's manual "pod" axis)."""
    if _compresses(recipe, mesh):
        rest = tuple(n for n in mesh.mesh_dim_names if n != "pod")
        return ShardingCtx(mesh[rest], _strip_pod(recipe))
    return ShardingCtx(mesh, recipe)


def state_shardings(cfg: ModelConfig, recipe: Recipe, mesh,
                    moment_dtype: str):
    """Shardings of ``{"params", "opt_state"}`` (None leaves without a
    mesh): moments and ``ef`` as their params.  0-d leaves (the step, an
    int8 moment's scale) stay plain tensors, which DTensor takes as
    replicated."""
    p_sh = tree_shardings(param_ctx(recipe, mesh),
                          params_mod.param_defs(cfg))
    if moment_dtype == "int8":
        moments = map_tree(lambda s: {"q": s, "s": None}, p_sh)
    else:
        moments = p_sh
    opt = {"m": moments, "v": moments, "step": None}
    if _compresses(recipe, mesh):
        opt["ef"] = p_sh
    return {"params": p_sh, "opt_state": opt}


def shard_state(state, cfg: ModelConfig, recipe: Recipe, mesh,
                moment_dtype: str):
    """``state`` with every plain tensor leaf placed by
    :func:`state_shardings` (DTensor leaves kept): what a restart from a
    checkpoint's host arrays needs before the next step."""
    sh = state_shardings(cfg, recipe, mesh, moment_dtype)

    def go(x, s):
        if isinstance(x, dict):
            return {k: go(v, s[k]) for k, v in x.items()}
        return x if is_dtensor(x) else place(x, s)

    return {k: go(state[k], sh[k]) for k in state}


def _batch_dims(key: str, x) -> tuple:
    dims = [None] * x.dim()
    dims[_batch_axis(key)] = "batch"
    return tuple(dims)


def _pod_slice(batch: Dict[str, Any], mesh) -> Dict[str, Any]:
    """This pod's block of every input along its batch axis."""
    n = mesh.size(mesh.mesh_dim_names.index("pod"))
    p = mesh.get_local_rank("pod")
    out = {}
    for k, x in batch.items():
        ax = _batch_axis(k)
        rows = x.shape[ax] // n
        out[k] = x.narrow(ax, p * rows, rows)
    return out


def _replicated(x):
    from torch.distributed.tensor import Replicate
    return x.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim)


def _plain(x):
    return x.full_tensor() if is_dtensor(x) else x


def make_train_step(cfg: ModelConfig, recipe: Recipe, mesh,
                    opt_cfg: opt_mod.AdamWConfig):
    lr_fn = opt_mod.cosine_schedule(opt_cfg)
    compress = _compresses(recipe, mesh)
    ctx = param_ctx(recipe, mesh)

    def step(params, opt_state, batch):
        if compress:
            batch = _pod_slice(batch, mesh)
        if ctx.mesh is not None:
            batch = {k: x if is_dtensor(x) else
                     place(x, ctx.sharding(x.shape, _batch_dims(k, x)))
                     for k, x in batch.items()}
        loss, grads = _grads_fn(params, batch, cfg, ctx)
        if compress:
            grads, ef = compression.compressed_pod_mean(
                grads, opt_state["ef"], mesh)
            opt_state = dict(opt_state, ef=ef)
        core = {k: opt_state[k] for k in ("m", "v", "step")}
        params, core, metrics = opt_mod.adamw_update(
            grads, core, params, opt_cfg, lr_fn)
        metrics["loss"] = loss
        return params, dict(opt_state, **core), {k: _plain(v) for k, v
                                                 in metrics.items()}

    return step


def init_opt_state(params, cfg: ModelConfig, recipe: Recipe,
                   opt_cfg: opt_mod.AdamWConfig):
    state = opt_mod.adamw_init(params, opt_cfg)
    if recipe.compress_pod_grads:
        state["ef"] = map_tree(lambda p: torch.zeros_like(
            p, dtype=torch.float32), params)
    return state
