"""Helpers shared by the port's training parity tests against JAX (CPU):
configs of both packages, batches, trees moved between them, and
loss-and-gradient runs of each package on the same weights."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import ARCHS, reduced
from repro.data.pipeline import TokenPipeline
from repro.distributed.sharding import Recipe, ShardingCtx
from repro.models import model as jmodel
from repro_torch.configs import ARCHS as TARCHS
from repro_torch.configs import reduced as treduced
from repro_torch.distributed.sharding import Recipe as TRecipe
from repro_torch.distributed.sharding import ShardingCtx as TCtx
from repro_torch.models import model as tmodel
from repro_torch.train.optimizer import leaves

from _torch_lm import perturbed_tree


def configs(arch, dtype="float32", **kw):
    """(JAX config, port config) of ``reduced(arch)`` in ``dtype``."""
    return (dataclasses.replace(reduced(ARCHS[arch]), dtype=dtype, **kw),
            dataclasses.replace(treduced(TARCHS[arch]), dtype=dtype, **kw))


def pipeline(cfg, batch, seq, seed=3):
    return TokenPipeline(
        cfg.vocab_size, batch, seq, seed=seed,
        num_codebooks=cfg.num_codebooks,
        vlm_tokens=cfg.num_vision_tokens if cfg.family == "vlm" else 0,
        patch_dim=cfg.vision_patch_dim)


def flat(tree):
    """{"a/b/c": leaf} of a nested dict of arrays or tensors."""
    return {"/".join(p): x for p, x in leaves(tree)}


def to_numpy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy() if x.dtype == torch.bfloat16 \
            else x.detach().numpy()
    return np.asarray(x, np.float32) if x.dtype == jnp.bfloat16 \
        else np.asarray(x)


def to_torch(tree):
    """A JAX (or numpy) tree as CPU tensors of the same dtypes."""
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    a = np.asarray(tree)
    if a.dtype == jnp.bfloat16:
        return torch.as_tensor(a.astype(np.float32)).to(torch.bfloat16)
    return torch.as_tensor(a.copy())


def rel_max(t, j):
    """max |t - j| over max |j| (0 when both are 0)."""
    t, j = to_numpy(t), to_numpy(j)
    scale = np.abs(j).max()
    return float(np.abs(t - j).max() / scale) if scale else float(
        np.abs(t).max())


def jax_loss_and_grads(cfg, tree, batch, recipe):
    """Loss and gradients of JAX's ``loss_fn`` at ``tree`` (numpy, cast
    to the compute dtype of ``cfg`` for bfloat16)."""
    dt = jnp.bfloat16 if cfg.dtype == "bfloat16" else jnp.float32
    params = jax.tree.map(lambda a: jnp.asarray(a, dt), tree)
    ctx = ShardingCtx(None, recipe)
    return jax.jit(jax.value_and_grad(
        lambda p, b: jmodel.loss_fn(p, cfg, b, ctx)))(
            params, {k: jnp.asarray(v) for k, v in batch.items()})


def torch_loss_and_grads(tcfg, tree, batch, recipe):
    """Loss and {path: gradient} of the port's ``loss_fn`` at ``tree``."""
    dt = torch.bfloat16 if tcfg.dtype == "bfloat16" else torch.float32
    params = jax.tree.map(
        lambda a: torch.as_tensor(np.array(a, np.float32)).to(dt)
        .requires_grad_(), tree)
    loss = tmodel.loss_fn(params, tcfg, {k: torch.as_tensor(v)
                                         for k, v in batch.items()},
                          TCtx(None, recipe))
    loss.backward()
    return loss.detach(), {k: v.grad for k, v in flat(params).items()}


__all__ = ["configs", "pipeline", "flat", "to_numpy", "to_torch", "rel_max",
           "jax_loss_and_grads", "torch_loss_and_grads", "perturbed_tree",
           "Recipe", "TRecipe"]
