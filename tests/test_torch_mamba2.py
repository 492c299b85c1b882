"""The port's Zamba2 hybrid serving path (Mamba2 SSD blocks + a shared
attention+MLP block) against the JAX package on shared weights (CPU).

``reduced(zamba2-2.7b)`` (4 Mamba2 layers as 2 groups of 2, the shared
block after each group, head_dim 16, chunk 32) carries the JAX
``init_params`` pytree across, every constant-initialised leaf perturbed.
A 288-token prompt is past the 256-token dense cutoff, so the shared
block's prefill runs the flash kernel under ``attn_impl="pallas"``
(Pallas interpret mode in JAX, the plain version in the port) and the
blockwise one under ``"blockwise"``.  Float32 holds logits and every state
leaf to 1e-4 of their max-abs (a leaf stored in bfloat16 to one bf16 ulp
of it) and greedy tokens equal; bfloat16 to 2e-2.  The SSD chunk form is
held to JAX's and to its own stepwise recurrence.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, reduced
from repro.distributed.sharding import Recipe, ShardingCtx
from repro.models import mamba2 as jm2
from repro.serve.engine import ServeEngine as JEngine
from repro_torch.configs import ARCHS as TARCHS
from repro_torch.configs import reduced as treduced
from repro_torch.distributed.sharding import Recipe as TRecipe
from repro_torch.distributed.sharding import ShardingCtx as TCtx
from repro_torch.models import mamba2 as tm2
from repro_torch.serve.engine import ServeEngine as TEngine

from _torch_lm import (_rel, _tol, cache_rel, decode_step_matches, jax_prefill,
                       leaf_tol, make_world, perturbed_tree, torch_prefill)

ARCH = "zamba2-2.7b"
PROMPT = 288
SHORT = 64          # the engine's blockwise case
NEW = 3
JCTX = ShardingCtx(None, Recipe(remat="none"))
TCTX = TCtx(None, TRecipe(remat="none"))


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def world(request):
    return make_world(ARCH, request.param, PROMPT)


@pytest.mark.parametrize("impl", ["pallas", "blockwise"])
def test_prefill_and_decode_fn_match_jax(world, impl):
    tol = _tol(world["dtype"])
    toks = world["tokens"]
    jl, jc = jax_prefill(world, impl, {"tokens": toks})
    tl, tc = torch_prefill(world, impl, {"tokens": toks})
    assert tl.dtype == torch.float32 and tuple(tl.shape) == jl.shape
    assert _rel(tl, jl) <= tol
    assert set(tc) == set(jc) == {"conv", "ssm", "k", "v"}
    for name in tc:
        assert tuple(tc[name].shape) == jc[name].shape
        assert str(tc[name].dtype).split(".")[1] == str(jc[name].dtype)
        assert cache_rel(world, tc[name], jc[name]) <= tol
    nxt = np.asarray(jnp.argmax(jl, -1), np.int32)[:, None]
    jnew, tnew = decode_step_matches(world, impl, jc, tc, nxt, PROMPT, tol)
    for name in ("conv", "ssm"):
        assert str(tnew[name].dtype).split(".")[1] == str(jnew[name].dtype)
        assert _rel(tnew[name], jnew[name]) <= leaf_tol(world, tnew[name])
    for name in ("k", "v"):         # the shared block's cache, in place
        assert _rel(tnew[name][:, :, PROMPT], jnew[name][:, :, PROMPT]) \
            <= leaf_tol(world, tnew[name])


@pytest.mark.parametrize("impl", ["pallas", "blockwise"])
def test_serve_engine_generate_matches_jax(impl):
    world = make_world(ARCH, "float32", PROMPT)
    toks = world["tokens"] if impl == "pallas" else world["tokens"][:, :SHORT]
    n = toks.shape[1]
    jres = JEngine(world["cfg"], world["jparams"],
                   recipe=Recipe(remat="none", attn_impl=impl),
                   max_seq=n + NEW + 8).generate(toks, NEW)
    tres = TEngine(world["tcfg"], world["tparams"],
                   recipe=TRecipe(remat="none", attn_impl=impl),
                   max_seq=n + NEW + 8, device="cpu").generate(toks, NEW)
    assert tres.tokens.shape == jres.tokens.shape == (2, n + NEW)
    jl, _ = jax_prefill(world, impl, {"tokens": toks})
    assert _rel(tres.prefill_logits, jl) <= 1e-4
    np.testing.assert_array_equal(tres.tokens, jres.tokens)


def _block(cfg, g=0, k=1):
    tree = perturbed_tree(cfg, 4)
    jblk = jax.tree.map(lambda a: jnp.asarray(a[g, k]), tree["mamba"])
    tblk = {n: torch.as_tensor(np.asarray(v[g, k])) for n, v in
            tree["mamba"].items()}
    return jblk, tblk


def _x(cfg, t):
    return np.random.default_rng(1).standard_normal(
        (2, t, cfg.d_model)).astype(np.float32) * 0.1


@pytest.mark.parametrize("chunk", [16, 32, 128])
def test_mamba2_block_matches_jax_chunk_form(chunk):
    cfg = dataclasses.replace(reduced(ARCHS[ARCH]), chunk_size=chunk)
    tcfg = dataclasses.replace(treduced(TARCHS[ARCH]), chunk_size=chunk)
    jblk, tblk = _block(cfg)
    x = _x(cfg, 256)
    jh, (jconv, jssm) = jm2.mamba2_block(jnp.asarray(x), jblk, cfg, JCTX)
    th, (tconv, tssm) = tm2.mamba2_block(torch.as_tensor(x), tblk, tcfg, TCTX)
    assert _rel(th, jh) <= 1e-5
    assert _rel(tconv, jconv) <= 1e-5
    assert _rel(tssm, jssm) <= 1e-5


def test_mamba2_chunked_equals_its_stepwise_recurrence():
    tcfg = treduced(TARCHS[ARCH])
    _, tblk = _block(reduced(ARCHS[ARCH]))
    x = torch.as_tensor(_x(tcfg, 2 * tcfg.chunk_size + 7))
    h_full, (conv, ssm) = tm2.mamba2_block(x, tblk, tcfg, TCTX)
    din = tcfg.expand * tcfg.d_model
    conv_p = torch.zeros(2, tcfg.conv_width - 1, din)
    ssm_p = torch.zeros(2, din // tcfg.ssm_head_dim, tcfg.ssm_head_dim,
                        tcfg.ssm_state_dim)
    outs = []
    for t in range(x.shape[1]):
        h_t, (conv_p, ssm_p) = tm2.mamba2_block_decode(
            x[:, t:t + 1], tblk, tcfg, TCTX, conv_p, ssm_p)
        outs.append(h_t)
    torch.testing.assert_close(h_full, torch.cat(outs, 1), atol=5e-5,
                               rtol=1e-4)
    torch.testing.assert_close(ssm, ssm_p, atol=5e-5, rtol=1e-4)
    torch.testing.assert_close(conv, conv_p)


def test_init_hybrid_state_shapes():
    tcfg = treduced(TARCHS[ARCH])
    spec = tm2.init_hybrid_state(tcfg, 3, 40)
    assert {k: (tuple(v.shape), v.dtype) for k, v in spec.items()} == {
        "conv": ((2, 2, 3, 3, 256), torch.bfloat16),
        "ssm": ((2, 2, 3, 16, 16, 16), torch.float32),
        "k": ((2, 3, 40, 8, 16), torch.bfloat16),
        "v": ((2, 3, 40, 8, 16), torch.bfloat16)}
