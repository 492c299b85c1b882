"""Helpers shared by the port's LM-family parity tests against JAX (CPU):
perturbed shared weights, prompts, prefill in both packages, one decode
step on JAX's prefill state spliced by JAX's rule, and the tolerances."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import ARCHS, reduced
from repro.configs.base import ShapeSpec
from repro.distributed.sharding import Recipe, ShardingCtx
from repro.models import model as jmodel
from repro.models.params import init_params as jinit
from repro_torch import convert
from repro_torch.configs import ARCHS as TARCHS
from repro_torch.configs import reduced as treduced
from repro_torch.distributed.sharding import Recipe as TRecipe
from repro_torch.distributed.sharding import ShardingCtx as TCtx
from repro_torch.models import model as tmodel


def _tol(dtype):
    return 2e-2 if dtype == "bfloat16" else 1e-4


def _rel(t, j):
    j = np.asarray(j, np.float32)
    return float(np.abs(t.float().numpy() - j).max() / np.abs(j).max())


def perturbed_tree(cfg, seed=0):
    """JAX ``init_params`` as numpy, every constant-initialised leaf moved
    by 0.1 N(0, 1) so that norms, biases and mixes are exercised."""
    tree = jax.tree.map(np.asarray, jinit(cfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 1)
    return jax.tree.map(
        lambda a: a + 0.1 * rng.standard_normal(a.shape).astype(np.float32)
        if a.size > 1 and np.all(a == a.flat[0]) else a, tree)


def prompts_for(cfg, n, seed=2, batch=2):
    shape = (batch, n) + ((cfg.num_codebooks,) if cfg.family == "audio"
                          else ())
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def cache_rel(world, t, j):
    """``_rel`` of a prefill state leaf (layer-stacked, rows over the last
    two dims).  In bfloat16 a one-ulp rounding difference between the
    packages can grow: a MoE token whose top-k has a near-tie picks
    another expert (its rows in later layers differ by O(1)), and the
    hybrid's second group reads Mamba2 states that bf16 moved (both
    packages' bf16 K there lie ~0.4 of max-abs from their float32 forward,
    ~4x further on average than from each other).  So in bfloat16 the rows
    beyond the tolerance may be at most one in a hundred, and the rest are
    held; float32 holds every row."""
    if world["dtype"] != "bfloat16":
        return _rel(t, j)
    j = np.asarray(j, np.float32)
    d = np.abs(t.float().numpy() - j)
    d = d.reshape(-1, *d.shape[-2:]).max(axis=(-1, -2)) / np.abs(j).max()
    tol = _tol(world["dtype"])
    assert (d > tol).mean() <= 0.01, np.argwhere(d > tol).tolist()
    return float(np.where(d > tol, 0.0, d).max())


def make_world(arch, dtype, prompt):
    cfg = dataclasses.replace(reduced(ARCHS[arch]), dtype=dtype)
    tcfg = dataclasses.replace(treduced(TARCHS[arch]), dtype=dtype)
    tree = perturbed_tree(cfg)
    return dict(cfg=cfg, tcfg=tcfg, dtype=dtype,
                jparams=jax.tree.map(jnp.asarray, tree),
                tparams=convert.params_from_jax(tree, device="cpu"),
                tokens=prompts_for(cfg, prompt))


def leaf_tol(world, leaf):
    """The world's tolerance, or one bf16 ulp of the max-abs for a leaf
    stored in bfloat16 (two float32 forwards may round an entry apart)."""
    return max(_tol(world["dtype"]),
               2.0 ** -7 if leaf.dtype == torch.bfloat16 else 0.0)


def ctxs(impl):
    return (ShardingCtx(None, Recipe(remat="none", attn_impl=impl)),
            TCtx(None, TRecipe(remat="none", attn_impl=impl)))


def jax_prefill(world, impl, batch):
    jctx, _ = ctxs(impl)
    cfg = world["cfg"]
    return jax.jit(lambda p, b: jmodel.prefill_fn(p, cfg, b, jctx))(
        world["jparams"], {k: jnp.asarray(v) for k, v in batch.items()})


def torch_prefill(world, impl, batch):
    _, tctx = ctxs(impl)
    with torch.inference_mode():
        return tmodel.prefill_fn(
            world["tparams"], world["tcfg"],
            {k: torch.as_tensor(v).long() if v.dtype == np.int32
             else torch.as_tensor(v) for k, v in batch.items()}, tctx)


def decode_step_matches(world, impl, jc, tc_prefill, nxt, prompt, tol):
    """One decode step on the JAX prefill's state spliced into decode
    buffers by JAX's rule, in both packages; returns the two new caches."""
    cfg, tcfg = world["cfg"], world["tcfg"]
    jctx, tctx = ctxs(impl)
    shape = ShapeSpec("t", "decode", prompt + 8, 2)
    specs = tmodel.cache_specs(tcfg, shape)
    jspecs = jmodel.cache_specs(cfg, shape)
    assert set(specs) == set(jspecs) == set(jc)
    jcache, tcache = {}, {}
    for name, s in specs.items():
        assert s.device.type == "meta"
        assert tuple(s.shape) == jspecs[name].shape
        src = np.asarray(jc[name], np.float32)
        if src.shape != tuple(s.shape):
            buf = np.zeros(s.shape, np.float32)
            buf[tuple(slice(0, n) for n in src.shape)] = src
        else:
            buf = src
        jcache[name] = jnp.asarray(buf, jspecs[name].dtype)
        tcache[name] = torch.as_tensor(buf).to(s.dtype)
        assert str(tcache[name].dtype).split(".")[1] == str(
            jcache[name].dtype)
    lens = np.full((2,), prompt, np.int32)
    jd, jnew = jax.jit(lambda p, b, c: jmodel.decode_fn(p, cfg, b, c, jctx))(
        world["jparams"], {"tokens": jnp.asarray(nxt),
                           "lengths": jnp.asarray(lens)}, jcache)
    with torch.inference_mode():
        td, tnew = tmodel.decode_fn(
            world["tparams"], tcfg,
            {"tokens": torch.as_tensor(nxt).long(),
             "lengths": torch.as_tensor(lens)}, tcache, tctx)
    assert td.shape == jd.shape and td.dtype == torch.float32
    assert _rel(td, jd) <= tol
    assert set(tnew) == set(jnew)
    return jnew, tnew
