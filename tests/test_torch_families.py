"""The port's MoE, VLM and audio serving paths and the int8 KV cache against
the JAX package on shared weights (CPU).

``reduced(qwen2-moe-a2.7b)`` (top-2 of 4 routed experts plus a shared
expert), ``reduced(qwen2-vl-7b)`` (M-RoPE sections 4/6/6, GQA 2:1) and
``reduced(musicgen-medium)`` (4 codebooks, GeLU MLP) carry the JAX
``init_params`` pytree across through ``convert.params_from_jax``; every
leaf JAX initialises to a constant (norm scales, biases) is perturbed so
that it matters.  A 288-token prompt is past the 256-token dense cutoff,
so prefill runs the flash kernel under ``attn_impl="pallas"`` (Pallas
interpret mode in JAX, the plain version in the port) and the blockwise
one under ``"blockwise"``; the engine's blockwise case takes the first 64
tokens.  Float32 configs hold logits and cache leaves to 1e-4 of their
max-abs (a leaf stored in bfloat16, such as the decode cache, to one bf16
ulp of it) and greedy tokens equal; bfloat16 configs hold them to 2e-2.  MoE routing is held exactly on inputs without
near-ties, the int8 cache bit-equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, SHAPES, reduced
from repro.configs.base import ShapeSpec
from repro.distributed.sharding import Recipe
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro.models import moe as jmoe
from repro.models import transformer as jtf
from repro.models.params import init_params as jinit
from repro.models.params import param_shapes as jshapes
from repro.serve.engine import ServeEngine as JEngine
from repro_torch import convert
from repro_torch.configs import ARCHS as TARCHS
from repro_torch.configs import reduced as treduced
from repro_torch.distributed.sharding import Recipe as TRecipe
from repro_torch.models import layers as tlayers
from repro_torch.models import model as tmodel
from repro_torch.models import moe as tmoe
from repro_torch.models import params as tparams
from repro_torch.models import transformer as ttf
from repro_torch.serve.engine import ServeEngine as TEngine

from _torch_lm import (_rel, _tol, cache_rel, ctxs, decode_step_matches,
                       jax_prefill, leaf_tol, make_world, perturbed_tree,
                       prompts_for, torch_prefill)

PROMPT = 288        # past the dense cutoff: reaches the flash kernel
SHORT = 64          # the engine's blockwise cases
NEW = 3
ARCH_NAMES = ("qwen2-moe-a2.7b", "qwen2-vl-7b", "musicgen-medium")
FAMILY_ARCHS = ("qwen2-moe-a2.7b", "phi3.5-moe-42b-a6.6b", "qwen2-vl-7b",
                "musicgen-medium", "rwkv6-3b", "zamba2-2.7b")


@pytest.fixture(scope="module", params=[(a, d) for a in ARCH_NAMES
                                        for d in ("float32", "bfloat16")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def world(request):
    return make_world(*request.param, PROMPT)


@pytest.fixture(scope="module", params=ARCH_NAMES)
def world32(request):
    return make_world(request.param, "float32", PROMPT)


@pytest.mark.parametrize("impl", ["pallas", "blockwise"])
def test_prefill_and_decode_fn_match_jax(world, impl):
    cfg = world["cfg"]
    tol = _tol(world["dtype"])
    toks = world["tokens"]
    n = toks.shape[1]
    jl, jc = jax_prefill(world, impl, {"tokens": toks})
    tl, tc = torch_prefill(world, impl, {"tokens": toks})
    want = ((2, cfg.num_codebooks, cfg.vocab_size) if cfg.family == "audio"
            else (2, cfg.vocab_size))
    assert tl.dtype == torch.float32 and tuple(tl.shape) == want == jl.shape
    assert _rel(tl, jl) <= tol
    for name in ("k", "v"):
        assert tc[name].shape == jc[name].shape
        assert cache_rel(world, tc[name], jc[name]) <= tol
    nxt = np.asarray(jnp.argmax(jl, -1), np.int32)[:, None]
    jnew, tnew = decode_step_matches(world, impl, jc, tc, nxt, n, tol)
    for name in ("k", "v"):
        assert _rel(tnew[name][:, :, n], jnew[name][:, :, n]) <= leaf_tol(
            world, tnew[name])


@pytest.mark.parametrize("impl", ["pallas", "blockwise"])
def test_serve_engine_generate_matches_jax(world32, impl):
    world = world32
    cfg, tcfg = world["cfg"], world["tcfg"]
    toks = world["tokens"] if impl == "pallas" else world["tokens"][:, :SHORT]
    n = toks.shape[1]
    jres = JEngine(cfg, world["jparams"],
                   recipe=Recipe(remat="none", attn_impl=impl),
                   max_seq=n + NEW + 8).generate(toks, NEW)
    tres = TEngine(tcfg, world["tparams"],
                   recipe=TRecipe(remat="none", attn_impl=impl),
                   max_seq=n + NEW + 8, device="cpu").generate(toks, NEW)
    assert tres.tokens.shape == jres.tokens.shape
    assert tres.tokens.shape[:2] == (2, n + NEW)
    assert (tres.tokens[:, :n] == toks).all()
    jl, _ = jax_prefill(world, impl, {"tokens": toks})
    assert _rel(tres.prefill_logits, jl) <= 1e-4
    np.testing.assert_array_equal(tres.tokens, jres.tokens)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vlm_prefill_with_vision_embeds_and_positions_3d(dtype):
    """The vision merger and M-RoPE prefill, which the engine (tokens only)
    never reaches, with inputs shaped as ``input_specs`` gives them."""
    w = make_world("qwen2-vl-7b", dtype, 64)
    cfg, tcfg = w["cfg"], w["tcfg"]
    shape = ShapeSpec("t", "prefill", 64, 2)
    specs = tmodel.input_specs(tcfg, shape)
    jspecs = jmodel.input_specs(cfg, shape)
    assert {k: tuple(v.shape) for k, v in specs.items()} == \
        {k: v.shape for k, v in jspecs.items()}
    rng = np.random.default_rng(5)
    pos = np.stack([np.arange(64) // 3, np.arange(64) % 7,
                    np.arange(64)])[:, None].repeat(2, 1).astype(np.int32)
    batch = {"tokens": w["tokens"],
             "vision_embeds": rng.standard_normal(
                 tuple(specs["vision_embeds"].shape)).astype(np.float32),
             "positions_3d": pos}
    jl, jc = jax_prefill(w, "blockwise", batch)
    tl, tc = torch_prefill(w, "blockwise", batch)
    tol = _tol(dtype)
    assert _rel(tl, jl) <= tol
    for name in ("k", "v"):
        assert _rel(tc[name], jc[name]) <= tol
    # the merger is live: dropping the vision inputs moves the logits
    tl0, _ = torch_prefill(w, "blockwise", {"tokens": w["tokens"]})
    assert float((tl0 - tl).abs().max()) > 10 * tol * float(tl.abs().max())


def test_mrope_matches_jax_and_equals_rope_at_equal_positions():
    x = np.random.default_rng(0).standard_normal((2, 8, 4, 32)).astype(
        np.float32)
    pos = np.broadcast_to(np.arange(8)[None], (2, 8)).astype(np.int32)
    pos3 = np.broadcast_to(pos[None], (3, 2, 8)).copy()
    pos3[1] = pos3[1] // 2
    for p3 in (np.broadcast_to(pos[None], (3, 2, 8)), pos3):
        j = jlayers.mrope(jnp.asarray(x), jnp.asarray(p3), (4, 6, 6), 1e4)
        t = tlayers.mrope(torch.as_tensor(x), torch.as_tensor(p3),
                          (4, 6, 6), 1e4)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-6)
    same = tlayers.mrope(torch.as_tensor(x), torch.as_tensor(
        np.broadcast_to(pos[None], (3, 2, 8)).copy()), (4, 6, 6), 1e4)
    rope = tlayers.rope(torch.as_tensor(x), torch.as_tensor(pos), 1e4)
    np.testing.assert_allclose(same.numpy(), rope.numpy(), atol=1e-5)


# ---------------------------------------------------------------------------
# MoE routing
# ---------------------------------------------------------------------------

def _moe_inputs(t, d, e, e_pad, f, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, t // 2, d)).astype(np.float32)
    router = (rng.standard_normal((d, e)) * 0.5).astype(np.float32)
    ws = [(rng.standard_normal(s) * 0.2).astype(np.float32)
          for s in ((e_pad, d, f), (e_pad, d, f), (e_pad, f, d))]
    return x, router, ws


def _jax_routing(x, router, top_k, e_pad, cf):
    """The routing lines of ``repro/models/moe.py`` as JAX runs them."""
    t = x.shape[0] * x.shape[1]
    probs = jax.nn.softmax(jnp.einsum("td,de->te", x.reshape(t, -1), router,
                                      preferred_element_type=jnp.float32),
                           axis=-1)
    gates, idx = jax.lax.top_k(probs, top_k)
    capacity = int(max(1, -(-t * top_k * cf // e_pad)))
    onehot = jax.nn.one_hot(idx.reshape(-1), e_pad, dtype=jnp.int32)
    pos = jnp.sum((jnp.cumsum(onehot, axis=0) - onehot) * onehot, axis=-1)
    return (np.asarray(probs), np.asarray(idx), np.asarray(pos),
            np.asarray(pos < capacity), capacity)


@pytest.mark.parametrize("t,e,top_k,cf", [
    (64, 4, 2, 1.25),      # reduced qwen2-moe: ample capacity
    (64, 60, 4, 1.25),     # 60 routed experts padded to 64
    (4, 60, 4, 1.25),      # a decode step: capacity 1, tokens collide
    (48, 16, 2, 0.5),      # phi3.5-moe's 16 experts at half capacity
])
def test_moe_routing_and_output_match_jax(t, e, top_k, cf):
    d, f = 16, 24
    e_pad = tparams.padded_experts(e)
    for seed in range(t + e, t + e + 50):  # the first draw with no near-tie
        x, router, ws = _moe_inputs(t, d, e, e_pad, f, seed)
        probs, idx, pos, keep, capacity = _jax_routing(x, router, top_k,
                                                       e_pad, cf)
        srt = -np.sort(-probs, axis=-1)
        if (srt[:, :top_k] - srt[:, 1:top_k + 1]).min() > 1e-4:
            break
    else:
        pytest.fail("no draw without a near-tie in the top-k")
    r = tmoe.route(torch.as_tensor(x).reshape(t, d), torch.as_tensor(router),
                   top_k, e_pad, cf)
    np.testing.assert_array_equal(r.idx.numpy(), idx)
    np.testing.assert_array_equal(r.slot.numpy(), pos)
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    assert r.capacity == capacity
    if t == 4:
        assert capacity == 1 and not keep.all()        # collisions drop
    assert e_pad == (64 if e == 60 else e)
    assert idx.max() < e                               # padding never routed

    jo, jaux = jmoe.moe_block(jnp.asarray(x), jnp.asarray(router),
                              *map(jnp.asarray, ws), top_k, cf)
    to, taux = tmoe.moe_block(torch.as_tensor(x), torch.as_tensor(router),
                              *map(torch.as_tensor, ws), top_k, cf)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-5)
    assert abs(float(taux) - float(jaux)) <= 1e-6


# ---------------------------------------------------------------------------
# int8 KV cache
# ---------------------------------------------------------------------------

def test_quantize_kv_bit_equal_to_jax_with_ties():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 4, 32)).astype(np.float32)
    x[0, 0] = np.arange(32) - 15.5          # absmax 15.5: k + 0.5 ties
    x[1, 1] = 0.0                            # the 1e-6 floor
    jq, js = jtf._quantize_kv(jnp.asarray(x))
    tq, ts = ttf._quantize_kv(torch.as_tensor(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("arch", ["musicgen-medium", "qwen2-vl-7b",
                                  "qwen2-moe-a2.7b", "yi-34b"])
def test_int8_cache_decode_matches_jax(arch):
    """Two decode steps on an int8 cache (float32 model), logits within
    1e-4.  The new token's K/V come out of two float32 forwards that agree
    to ~1e-6, so its scales are held to rtol 1e-5 and its int8 values to
    one step (a value on a rounding boundary); every other entry stays
    bit-equal.  ``_quantize_kv`` itself is bit-equal on equal inputs (the
    test above)."""
    cfg = reduced(ARCHS[arch])
    cfg = dataclasses.replace(cfg, dtype="float32")
    tcfg = dataclasses.replace(treduced(TARCHS[arch]), dtype="float32")
    tree = perturbed_tree(cfg, seed=3)
    jp = jax.tree.map(jnp.asarray, tree)
    tp = convert.params_from_jax(tree, device="cpu")
    b, s = 2, 24
    specs = tmodel.cache_specs(tcfg, ShapeSpec("t", "decode", s, b),
                               kv_dtype=torch.int8)
    jspecs = jmodel.cache_specs(cfg, ShapeSpec("t", "decode", s, b),
                                kv_dtype=jnp.int8)
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[1])
            for k, v in specs.items()} == \
        {k: (v.shape, str(v.dtype)) for k, v in jspecs.items()}
    rng = np.random.default_rng(4)
    kv = {n: rng.standard_normal(specs[n].shape).astype(np.float32) * 0.5
          for n in ("k", "v")}
    cache_np = {}
    for n in ("k", "v"):
        q, sc = jtf._quantize_kv(jnp.asarray(kv[n]))
        cache_np[n], cache_np[n + "_scale"] = np.asarray(q), np.asarray(sc)
    jc = {n: jnp.asarray(a) for n, a in cache_np.items()}
    tc = {n: torch.as_tensor(a.copy()) for n, a in cache_np.items()}
    lens = np.array([5, 9], np.int32)
    jctx, tctx = ctxs("blockwise")
    for step in range(2):
        toks = prompts_for(cfg, 1, seed=10 + step)
        jl, jc = jmodel.decode_fn(jp, cfg, {"tokens": jnp.asarray(toks),
                                            "lengths": jnp.asarray(lens)},
                                  jc, jctx)
        with torch.inference_mode():
            tl, tc = tmodel.decode_fn(tp, tcfg,
                                      {"tokens": torch.as_tensor(toks).long(),
                                       "lengths": torch.as_tensor(lens)},
                                      tc, tctx)
        assert _rel(tl, jl) <= 1e-4
        for n in ("k", "v", "k_scale", "v_scale"):
            assert tc[n].dtype == (torch.int8 if len(n) == 1
                                   else torch.float32)
            t, j = tc[n].numpy().astype(np.float64), np.asarray(jc[n],
                                                                np.float64)
            new = np.zeros(t.shape[:3], bool)
            for done in range(step + 1):        # every position written
                new[:, np.arange(b), lens - done] = True
            np.testing.assert_array_equal(t[~new], j[~new])
            if len(n) == 1:
                assert np.abs(t[new] - j[new]).max() <= 1
            else:
                np.testing.assert_allclose(t[new], j[new], rtol=1e-5)
        lens = lens + 1


# ---------------------------------------------------------------------------
# Specs, parameter trees and the launcher for every family
# ---------------------------------------------------------------------------

def _meta_sig(tree):
    return {k: _meta_sig(v) if isinstance(v, dict)
            else (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in tree.items()}


def _jax_sig(tree):
    return {k: _jax_sig(v) if isinstance(v, dict)
            else (tuple(v.shape), str(v.dtype))
            for k, v in tree.items()}


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_specs_and_param_shapes_match_jax_at_full_size(arch):
    """Shapes only (meta tensors, nothing allocated): the full config's
    parameter tree (60 routed experts padded to 64, the hybrid's (G, K)
    Mamba2 stack) and every shape's inputs and decode cache."""
    cfg, tcfg = ARCHS[arch], TARCHS[arch]
    assert _meta_sig(tparams.param_shapes(tcfg)) == _jax_sig(jshapes(cfg))
    for shape in SHAPES.values():
        assert _meta_sig(tmodel.input_specs(tcfg, shape)) == \
            _jax_sig(jmodel.input_specs(cfg, shape))
        assert tmodel.input_dims(tcfg, shape) == jmodel.input_dims(cfg, shape)
        jc = jmodel.cache_specs(cfg, shape)
        tc = tmodel.cache_specs(tcfg, shape)
        assert (tc is None) == (jc is None)
        if jc is not None:
            assert _meta_sig(tc) == _jax_sig(jc)
    assert tmodel.cache_dims(tcfg) == jmodel.cache_dims(cfg)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_params_from_jax_and_init_params_hold_every_family_tree(arch):
    cfg, tcfg = reduced(ARCHS[arch]), treduced(TARCHS[arch])
    tree = jax.tree.map(np.asarray, jinit(cfg, jax.random.PRNGKey(3)))
    tp = convert.params_from_jax(tree, device="cpu", dtype=torch.bfloat16)
    drawn = tparams.init_params(tcfg, torch.Generator().manual_seed(0),
                                dtype=torch.bfloat16, device="cpu")
    sig = _jax_sig(jax.tree.map(lambda a: jnp.zeros(a.shape, jnp.bfloat16),
                                tree))
    assert _meta_sig(tp) == _meta_sig(drawn) == sig
    np.testing.assert_array_equal(
        tp["lm_head"].float().numpy(),
        np.asarray(jnp.asarray(tree["lm_head"], jnp.bfloat16), np.float32))
    if cfg.family == "hybrid":            # (G, K) slices drawn one by one
        w = drawn["mamba"]["wx"].float()
        assert w.shape[:2] == (2, 2)
        assert not torch.equal(w[0, 0], w[0, 1])
        assert not torch.equal(w[0, 1], w[1, 0])


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_launcher_serves_each_family_on_the_cpu(arch, capsys):
    from repro_torch.launch import serve as tserve

    tserve.main(["--arch", arch, "--device", "cpu", "--batch", "2",
                 "--prompt-len", "8", "--new-tokens", "2"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith(f"arch={ARCHS[arch].name}: generated 2 "
                               f"tokens/seq for 2 seqs; prefill=")
    assert lines[1].startswith(f"CAM KV plan ({ARCHS[arch].name}): block=")


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_every_arch_prefills_decodes_and_generates_on_the_cpu(arch):
    """All ten configs at ``reduced()`` size through ``cache_specs``,
    ``prefill_fn``, ``decode_fn`` and ``ServeEngine.generate``: shapes as
    JAX's, finite logits, the cache's leaves kept."""
    tcfg = treduced(TARCHS[arch])
    params = tparams.init_params(tcfg, torch.Generator().manual_seed(0),
                                 device="cpu")
    toks = prompts_for(tcfg, 40)
    _, tctx = ctxs("blockwise")
    with torch.inference_mode():
        logits, _ = tmodel.prefill_fn(params, tcfg,
                                      {"tokens": torch.as_tensor(toks).long()},
                                      tctx)
        specs = tmodel.cache_specs(tcfg, ShapeSpec("t", "decode", 48, 2))
        cache = {n: torch.zeros(s.shape, dtype=s.dtype) for n, s in
                 specs.items()}
        step, new = tmodel.decode_fn(
            params, tcfg, {"tokens": torch.as_tensor(toks[:, :1]).long(),
                           "lengths": torch.full((2,), 3, dtype=torch.int32)},
            cache, tctx)
    want = (2,) + ((tcfg.num_codebooks,) if tcfg.family == "audio" else ()) \
        + (tcfg.vocab_size,)
    assert tuple(logits.shape) == tuple(step.shape) == want
    assert torch.isfinite(logits).all() and torch.isfinite(step).all()
    assert {n: tuple(t.shape) for n, t in new.items()} == \
        {n: tuple(s.shape) for n, s in specs.items()}
    res = TEngine(tcfg, params, max_seq=48, device="cpu").generate(toks, 3)
    assert res.tokens.shape[:2] == (2, 43) and res.steps == 3
