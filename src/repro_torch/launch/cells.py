"""Cell construction: (arch x shape x mesh x recipe) -> a step and its
arguments.

Mirrors ``repro/launch/cells.py``; shared by ``dryrun.py``, ``roofline.py``
and ``chip_smoke.py``.  Where JAX returns a jitted function and
``ShapeDtypeStruct`` arguments, ``build_cell`` returns the step callable
(train, prefill or decode) and a builder of its arguments: DTensors on the
mesh (plain tensors without one), either fake ones under the caller's
``FakeTensorMode`` (each rank's local shard only, for a dry run) or real
ones drawn from a seed.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs import SHAPES, get_config
from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.distributed.elastic import reshard_tree
from repro_torch.distributed.sharding import (Recipe, ShardingCtx,
                                              tree_shardings)
from repro_torch.launch.mesh import production_shape
from repro_torch.models import model as model_mod
from repro_torch.models import params as params_mod
from repro_torch.train import optimizer as opt_mod
from repro_torch.train import train_step as ts_mod

__all__ = ["default_recipe", "build_cell", "cell_skip_reason", "CellSpec",
           "optimized_overrides"]


@dataclasses.dataclass(frozen=True)
class CellSpec:
    arch: str
    shape: str
    multi_pod: bool = False
    recipe_overrides: Tuple[Tuple[str, Any], ...] = ()

    def resolve(self):
        cfg = get_config(self.arch)
        shape = SHAPES[self.shape]
        return cfg, shape


def cell_skip_reason(cfg: ModelConfig, shape: ShapeSpec) -> Optional[str]:
    if shape.name == "long_500k" and not cfg.subquadratic:
        return ("skipped: pure full-attention arch; long_500k requires "
                "sub-quadratic attention (see DESIGN.md §Arch-applicability)")
    return None


def optimized_overrides(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, Any]:
    """Beyond-baseline recipe per cell, the JAX package's:

    * decode, wide dense models — weight-stationary decode: shard the
      residual d_model on "data" instead of all-gathering the weights per
      token step;
    * decode, any transformer — int8 KV cache with per-(token, head)
      scales: halves the dominant cache-streaming HBM term;
    * train, d_model >= 16384 — bf16 master params on top of the
      baseline's bf16 grad accumulation.
    """
    ov: Dict[str, Any] = {}
    if shape.kind == "decode" and cfg.family in ("dense", "moe", "vlm", "audio"):
        ov["kv_cache_dtype"] = "int8"
        if cfg.d_model >= 7168:
            ov.update(batch_axes=(), act_embed_axes=("data",),
                      kv_batch_axes=("data",))
    if shape.kind == "train" and cfg.d_model >= 16384:
        ov["param_dtype"] = "bfloat16"
    return ov


def default_recipe(cfg: ModelConfig, shape: ShapeSpec,
                   multi_pod: bool = False,
                   mesh_shape: Optional[Dict[str, int]] = None,
                   **overrides) -> Recipe:
    """The baseline recipe of a cell.  The data-parallel degree that sizes
    the microbatches comes from ``mesh_shape`` ({axis: size}; the H100
    production mesh by default), where JAX hard-codes its v5e mesh's 16
    and 32: on the v5e shapes the two recipes are equal."""
    batch_axes = ("pod", "data") if multi_pod else ("data",)
    kw: Dict[str, Any] = dict(batch_axes=batch_axes)
    if shape.kind == "train":
        if mesh_shape is None:
            dims, names = production_shape(multi_pod)
            mesh_shape = dict(zip(names, dims))
        # Gradient accumulation sized so activation checkpoints fit HBM:
        # target tokens/device/microbatch by model width.
        dp = math.prod(mesh_shape.get(a, 1) for a in batch_axes)
        per_dev_batch = max(1, shape.global_batch // dp)
        target_tokens = 16384 if cfg.d_model <= 3072 else \
            8192 if cfg.d_model <= 8192 else 4096
        want_mb = max(1, (per_dev_batch * shape.seq_len) // target_tokens)
        mb = 1
        while mb * 2 <= min(want_mb, per_dev_batch):
            mb *= 2
        kw["microbatch"] = mb
        kw["remat"] = "nested" if cfg.num_layers >= 32 else "block"
        if cfg.d_model >= 8192:
            kw["grad_dtype"] = "bfloat16"
    else:
        kw["remat"] = "none"
    kw.update(overrides)
    return Recipe(**kw)


# ---------------------------------------------------------------------------
# Arguments
# ---------------------------------------------------------------------------

def _fake_leaf(meta: torch.Tensor, sharding, device):
    """An empty tensor of ``meta``'s shape and dtype on ``device``, as a
    DTensor of its rank's local shard when ``sharding`` is given (made
    under the caller's ``FakeTensorMode``, it holds no memory)."""
    if sharding is None:
        return torch.empty(meta.shape, dtype=meta.dtype, device=device)
    from torch.distributed.tensor import DTensor, Shard
    local_shape = list(meta.shape)      # specs only shard even splits
    for i, p in enumerate(sharding.placements):
        if isinstance(p, Shard):
            local_shape[p.dim] //= sharding.mesh.size(i)
    local = torch.empty(local_shape, dtype=meta.dtype, device=device)
    return DTensor.from_local(local, sharding.mesh, sharding.placements,
                              run_check=False, shape=meta.shape,
                              stride=meta.stride())


def _fake_tree(metas, shardings, device):
    if isinstance(metas, dict):
        return {k: _fake_tree(metas[k], shardings[k], device) for k in metas}
    return _fake_leaf(metas, shardings, device)


def _real_inputs(cfg: ModelConfig, shape: ShapeSpec,
                 metas: Dict[str, torch.Tensor], gen: torch.Generator,
                 device) -> Dict[str, torch.Tensor]:
    out = {}
    for k, m in metas.items():
        if k == "tokens":
            out[k] = torch.randint(0, cfg.vocab_size, m.shape, generator=gen,
                                   device=device, dtype=torch.int64).to(m.dtype)
        elif k == "lengths":      # a context of half the cache
            out[k] = torch.full(m.shape, shape.seq_len // 2, dtype=m.dtype,
                                device=device)
        elif k == "positions_3d":
            s = m.shape[-1]
            out[k] = torch.arange(s, dtype=m.dtype, device=device).expand(
                m.shape).contiguous()
        else:
            out[k] = torch.randn(m.shape, generator=gen, device=device,
                                 dtype=torch.float32).to(m.dtype)
    return out


def _shardings_of(ctx: ShardingCtx, metas, dims):
    return {k: ctx.sharding(metas[k].shape, dims[k]) for k in metas}


def build_cell(cfg: ModelConfig, shape: ShapeSpec, mesh, recipe: Recipe,
               device="cuda", opt_cfg: Optional[opt_mod.AdamWConfig] = None
               ) -> Tuple[Callable, Callable]:
    """Returns ``(fn, make_args)``: ``fn(*make_args(fake=..., seed=...))``
    runs the cell's step (a train cell's AdamW is ``opt_cfg``, by default
    JAX's: the defaults with the recipe's or config's moment dtype).  ``make_args(fake=True)`` builds empty
    arguments (call it under ``FakeTensorMode``); ``fake=False`` draws
    the params from ``seed`` (``init_params``), tokens uniformly, and a
    zero cache, all on ``device``."""
    ctx = ShardingCtx(mesh, recipe)
    defs = params_mod.param_defs(cfg)
    batch_meta = model_mod.input_specs(cfg, shape)
    batch_sh = _shardings_of(ctx, batch_meta, model_mod.input_dims(cfg, shape))

    def params_of(pctx, dtype, fake, gen):
        sh = tree_shardings(pctx, defs)
        if fake:
            return _fake_tree(params_mod.param_shapes(cfg, dtype), sh, device)
        host = params_mod.init_params(cfg, gen, dtype=dtype, device=device)
        return reshard_tree(host, sh, device)

    def batch_of(fake, gen, placed=True):
        sh = batch_sh if placed else {k: None for k in batch_meta}
        if fake:
            return _fake_tree(batch_meta, sh, device)
        return reshard_tree(_real_inputs(cfg, shape, batch_meta, gen, device),
                            sh, device)

    if shape.kind == "train":
        pdt = torch.bfloat16 if recipe.param_dtype == "bfloat16" \
            else torch.float32
        if opt_cfg is None:
            opt_cfg = opt_mod.AdamWConfig(
                moment_dtype=recipe.moment_dtype or cfg.opt_moment_dtype)
        step = ts_mod.make_train_step(cfg, recipe, mesh, opt_cfg)
        pctx = ts_mod.param_ctx(recipe, mesh)
        # the pod-compressed step takes the whole batch and slices its pod's
        placed = pctx.mesh is mesh

        def make_train_args(fake: bool = False, seed: int = 0):
            gen = _generator(seed, device)
            params = params_of(pctx, pdt, fake, gen)
            opt_state = ts_mod.init_opt_state(params, cfg, recipe, opt_cfg)
            return params, opt_state, batch_of(fake, gen, placed)

        return step, make_train_args

    def make_args(fake: bool = False, seed: int = 0):
        gen = _generator(seed, device)
        args = [params_of(ctx, torch.bfloat16, fake, gen),
                batch_of(fake, gen)]
        if shape.kind == "decode":
            kv = torch.int8 if recipe.kv_cache_dtype == "int8" \
                else torch.bfloat16
            metas = model_mod.cache_specs(cfg, shape, kv)
            sh = _shardings_of(ctx, metas, model_mod.cache_dims(cfg))
            if fake:
                args.append(_fake_tree(metas, sh, device))
            else:
                args.append(reshard_tree(
                    {k: torch.zeros(m.shape, dtype=m.dtype, device=device)
                     for k, m in metas.items()}, sh, device))
        return tuple(args)

    if shape.kind == "prefill":
        @torch.no_grad()
        def prefill(params, batch):
            return model_mod.prefill_fn(params, cfg, batch, ctx)

        return prefill, make_args

    @torch.no_grad()
    def decode(params, batch, cache):
        return model_mod.decode_fn(params, cfg, batch, cache, ctx)

    return decode, make_args


def _generator(seed: int, device) -> torch.Generator:
    dev = torch.device(device)
    return torch.Generator(device=dev.type if dev.type != "meta" else "cpu"
                           ).manual_seed(seed)
