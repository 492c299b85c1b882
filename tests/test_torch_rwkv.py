"""The port's RWKV6 serving path against the JAX package on shared weights
(CPU), and the chunked WKV's finite answer where JAX's is not.

``reduced(rwkv6-3b)`` (8 heads of 16, chunk 32) carries the JAX
``init_params`` pytree across, every constant-initialised leaf (mixes,
decay LoRA, bonus, norms) perturbed so that it matters.  The family has no
attention, so ``attn_impl`` only names the recipe; both are run.  Float32
holds logits and state leaves to 1e-4 of their max-abs (a leaf stored in
bfloat16 to one bf16 ulp of it) and greedy tokens equal; bfloat16 to 2e-2.

JAX's chunk form multiplies ``r exp(cum_prev)`` by ``k exp(-cum)``; with
the seeded init's log decays of -1, ``exp(-cum)`` overflows float32 past
88 steps, so ``rwkv_block`` is NaN at chunk 128 (the full config's).  The
port's pairwise form is held to JAX's chunk form at chunks 32 and 64 and
to JAX's own stepwise recurrence at chunk 128.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, reduced
from repro.distributed.sharding import Recipe, ShardingCtx
from repro.models import rwkv as jrwkv
from repro.models.params import init_params as jinit
from repro.serve.engine import ServeEngine as JEngine
from repro_torch.configs import ARCHS as TARCHS
from repro_torch.configs import reduced as treduced
from repro_torch.distributed.sharding import Recipe as TRecipe
from repro_torch.distributed.sharding import ShardingCtx as TCtx
from repro_torch.models import rwkv as trwkv
from repro_torch.serve.engine import ServeEngine as TEngine

from _torch_lm import (_rel, _tol, cache_rel, decode_step_matches, jax_prefill,
                       leaf_tol, make_world, perturbed_tree, torch_prefill)

ARCH = "rwkv6-3b"
PROMPT = 96         # three chunks of 32
NEW = 4
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
    assert set(tc) == set(jc) == {"att", "tm", "cm"}
    for name in tc:
        assert tuple(tc[name].shape) == jc[name].shape
        assert str(tc[name].dtype).split(".")[1] == str(jc[name].dtype)
        assert cache_rel(world, tc[name], jc[name]) <= tol
    nxt = np.asarray(jnp.argmax(jl, -1), np.int32)[:, None]
    jnew, tnew = decode_step_matches(world, impl, jc, tc, nxt, PROMPT, tol)
    for name in tnew:     # the step's state takes the step's types, as JAX
        assert str(tnew[name].dtype).split(".")[1] == str(jnew[name].dtype)
        assert _rel(tnew[name], jnew[name]) <= leaf_tol(world, tnew[name])


@pytest.mark.parametrize("impl", ["pallas", "blockwise"])
def test_serve_engine_generate_matches_jax(impl):
    world = make_world(ARCH, "float32", PROMPT)
    toks = world["tokens"]
    jres = JEngine(world["cfg"], world["jparams"],
                   recipe=Recipe(remat="none", attn_impl=impl),
                   max_seq=PROMPT + NEW + 8).generate(toks, NEW)
    tres = TEngine(world["tcfg"], world["tparams"],
                   recipe=TRecipe(remat="none", attn_impl=impl),
                   max_seq=PROMPT + NEW + 8, device="cpu").generate(toks, NEW)
    assert tres.tokens.shape == jres.tokens.shape == (2, PROMPT + NEW)
    jl, _ = jax_prefill(world, impl, {"tokens": toks})
    assert _rel(tres.prefill_logits, jl) <= 1e-4
    np.testing.assert_array_equal(tres.tokens, jres.tokens)


def _block_inputs(cfg, t, seed=0, scale=0.1):
    x = np.random.default_rng(seed).standard_normal(
        (2, t, cfg.d_model)).astype(np.float32) * scale
    return x


def _blocks(cfg, tcfg, seed=0, perturb=True, w0_shift=0.0):
    tree = perturbed_tree(cfg, seed) if perturb else jax.tree.map(
        np.asarray, jinit(cfg, jax.random.PRNGKey(seed)))
    tree["blocks"]["w0"] = tree["blocks"]["w0"] + np.float32(w0_shift)
    jblk = jax.tree.map(lambda a: jnp.asarray(a[0]), tree["blocks"])
    tblk = {k: torch.as_tensor(np.asarray(v[0])) for k, v in
            tree["blocks"].items()}
    return jblk, tblk


def _jax_stepwise(x, jblk, cfg):
    b = x.shape[0]
    tm = jnp.zeros((b, cfg.d_model), jnp.float32)
    cm = jnp.zeros((b, cfg.d_model), jnp.float32)
    att = jnp.zeros((b, cfg.num_heads, cfg.ssm_head_dim, cfg.ssm_head_dim),
                    jnp.float32)
    step = jax.jit(lambda xt, tm, cm, att: jrwkv.rwkv_block_decode(
        xt, jblk, cfg, JCTX, tm, cm, att))
    outs = []
    for t in range(x.shape[1]):
        h_t, (tm, cm, att) = step(jnp.asarray(x[:, t:t + 1]), tm, cm, att)
        outs.append(np.asarray(h_t))
    return np.concatenate(outs, axis=1), np.asarray(att)


@pytest.mark.parametrize("chunk", [32, 64])
def test_chunked_block_matches_jax_chunk_form(chunk):
    """Where JAX's chunk form is finite: decays slowed (w0 - 1, log decays
    near -0.4) so that its ``exp(-cum)`` stays below float32's 88 over a
    64-step chunk, the mixes and decay LoRA perturbed."""
    cfg = dataclasses.replace(reduced(ARCHS[ARCH]), chunk_size=chunk)
    tcfg = dataclasses.replace(treduced(TARCHS[ARCH]), chunk_size=chunk)
    jblk, tblk = _blocks(cfg, tcfg, w0_shift=-1.0)
    x = _block_inputs(cfg, 4 * chunk)
    jh, (jtm, jcm, jatt) = jrwkv.rwkv_block(jnp.asarray(x), jblk, cfg, JCTX)
    assert np.isfinite(np.asarray(jh)).all()
    th, (ttm, tcm, tatt) = trwkv.rwkv_block(torch.as_tensor(x), tblk, tcfg,
                                            TCTX)
    assert _rel(th, jh) <= 1e-5
    for t, j in ((ttm, jtm), (tcm, jcm), (tatt, jatt)):
        assert _rel(t, j) <= 1e-5


def test_chunked_block_equals_its_stepwise_recurrence():
    """The port's chunk algebra against its own O(1) decode step."""
    tcfg = treduced(TARCHS[ARCH])
    _, tblk = _blocks(reduced(ARCHS[ARCH]), tcfg)
    x = torch.as_tensor(_block_inputs(tcfg, 2 * tcfg.chunk_size + 5))
    h_full, (tm, cm, att) = trwkv.rwkv_block(x, tblk, tcfg, TCTX)
    b, d = x.shape[0], tcfg.d_model
    tm_p, cm_p = torch.zeros(b, d), torch.zeros(b, d)
    att_p = torch.zeros(b, tcfg.num_heads, tcfg.ssm_head_dim,
                        tcfg.ssm_head_dim)
    outs = []
    for t in range(x.shape[1]):
        h_t, (tm_p, cm_p, att_p) = trwkv.rwkv_block_decode(
            x[:, t:t + 1], tblk, tcfg, TCTX, tm_p, cm_p, att_p)
        outs.append(h_t)
    torch.testing.assert_close(h_full, torch.cat(outs, 1), atol=5e-5,
                               rtol=1e-4)
    torch.testing.assert_close(att, att_p, atol=5e-5, rtol=1e-4)
    torch.testing.assert_close(tm, tm_p)
    torch.testing.assert_close(cm, cm_p)


def test_chunk_128_jax_is_nonfinite_and_the_port_matches_its_recurrence():
    """The reference fault pinned: at the full config's chunk 128, JAX's
    chunk form overflows (``exp(-cum)`` past 88 steps of log decay -1,
    the seeded init) and returns NaN; the port's block is finite and
    within 1e-3 of JAX's own stepwise recurrence."""
    cfg = dataclasses.replace(reduced(ARCHS[ARCH]), chunk_size=128)
    tcfg = dataclasses.replace(treduced(TARCHS[ARCH]), chunk_size=128)
    jblk, tblk = _blocks(cfg, tcfg, perturb=False)
    assert float(np.asarray(jblk["w0"]).max()) == 0.0   # log decay -1
    x = _block_inputs(cfg, 256)
    jh, (_, _, jatt) = jrwkv.rwkv_block(jnp.asarray(x), jblk, cfg, JCTX)
    assert not np.isfinite(np.asarray(jh)).all()
    th, (_, _, tatt) = trwkv.rwkv_block(torch.as_tensor(x), tblk, tcfg, TCTX)
    assert torch.isfinite(th).all() and torch.isfinite(tatt).all()
    h_seq, att_seq = _jax_stepwise(x, jblk, cfg)
    assert _rel(th, h_seq) <= 1e-3
    assert _rel(tatt, att_seq) <= 1e-3


def test_init_rwkv_state_and_decode_return_jax_types():
    tcfg = treduced(TARCHS[ARCH])
    spec = trwkv.init_rwkv_state(tcfg, 3)
    assert {k: (tuple(v.shape), v.dtype) for k, v in spec.items()} == {
        "att": ((2, 3, 8, 16, 16), torch.float32),
        "tm": ((2, 3, 128), torch.bfloat16),
        "cm": ((2, 3, 128), torch.bfloat16)}
    assert all(v.device.type == "meta" for v in spec.values())
