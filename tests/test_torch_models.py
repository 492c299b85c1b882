"""The port's serving path against the JAX package on shared weights (CPU).

``reduced(yi-34b)`` (SwiGLU, GQA) and ``reduced(starcoder2-3b)`` (GeLU MLP
with biases, GQA) carry the JAX ``init_params`` pytree across through
``convert.params_from_jax`` (norm scales and biases perturbed so that they
matter).  A 288-token prompt is past the 256-token dense cutoff, so
``attn_impl="pallas"`` runs the flash kernel (Pallas interpret mode in JAX,
the plain version in the port) and decode the decode kernel's plain
version.  Float32 configs hold logits to 1e-4 of their max-abs and greedy
tokens equal; bfloat16 configs hold logits to 2e-2.  The KV planner and
pool are held to 1e-6 on the mixes of ``tests/test_serve.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, reduced
from repro.distributed.sharding import Recipe, ShardingCtx
from repro.models import model as jmodel
from repro.models.params import init_params as jinit
from repro.serve import kv_cache as jkv
from repro.serve import planner as jplan
from repro.serve.engine import ServeEngine as JEngine
from repro_torch import convert
from repro_torch.configs import ARCHS as TARCHS
from repro_torch.configs import reduced as treduced
from repro_torch.configs.base import ShapeSpec
from repro_torch.distributed.sharding import Recipe as TRecipe
from repro_torch.distributed.sharding import ShardingCtx as TCtx
from repro_torch.models import model as tmodel
from repro_torch.models import params as tparams
from repro_torch.serve import kv_cache as tkv
from repro_torch.serve import planner as tplan
from repro_torch.serve.engine import ServeEngine as TEngine

PROMPT = 288
NEW = 4
ARCH_NAMES = ("yi-34b", "starcoder2-3b")


def _tol(dtype):
    return 2e-2 if dtype == "bfloat16" else 1e-4


def _rel(t, j):
    j = np.asarray(j, np.float32)
    return float(np.abs(t.float().numpy() - j).max() / np.abs(j).max())


@pytest.fixture(scope="module", params=[(a, d) for a in ARCH_NAMES
                                        for d in ("float32", "bfloat16")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def world(request):
    arch, dtype = request.param
    cfg = dataclasses.replace(reduced(ARCHS[arch]), dtype=dtype)
    tcfg = dataclasses.replace(treduced(TARCHS[arch]), dtype=dtype)
    tree = jax.tree.map(np.asarray, jinit(cfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)
    for name, leaf in tree["blocks"].items():
        if name.startswith(("b", "ln")):
            tree["blocks"][name] = leaf + 0.1 * rng.standard_normal(
                leaf.shape).astype(np.float32)
    tokens = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, PROMPT)).astype(np.int32)
    return dict(cfg=cfg, tcfg=tcfg, dtype=dtype,
                jparams=jax.tree.map(jnp.asarray, tree),
                tparams=convert.params_from_jax(tree, device="cpu"),
                tokens=tokens)


@pytest.mark.parametrize("impl", ["pallas", "blockwise"])
def test_prefill_and_decode_fn_match_jax(world, impl):
    cfg, tcfg = world["cfg"], world["tcfg"]
    jctx = ShardingCtx(None, Recipe(remat="none", attn_impl=impl))
    tctx = TCtx(None, TRecipe(remat="none", attn_impl=impl))
    toks = world["tokens"]
    jl, jc = jax.jit(lambda p, b: jmodel.prefill_fn(p, cfg, b, jctx))(
        world["jparams"], {"tokens": jnp.asarray(toks)})
    with torch.inference_mode():
        tl, tc = tmodel.prefill_fn(world["tparams"], tcfg,
                                   {"tokens": torch.as_tensor(toks).long()},
                                   tctx)
    tol = _tol(world["dtype"])
    assert tl.dtype == torch.float32 and tl.shape == (2, cfg.vocab_size)
    assert _rel(tl, jl) <= tol
    for name in ("k", "v"):
        assert tc[name].shape == jc[name].shape
        assert _rel(tc[name], jc[name]) <= tol

    # one decode step on the JAX prefill's cache, spliced into bf16 buffers
    shape = ShapeSpec("t", "decode", PROMPT + 8, 2)
    specs = tmodel.cache_specs(tcfg, shape)
    assert all(s.device.type == "meta" and s.dtype == torch.bfloat16
               for s in specs.values())
    jcache, tcache = {}, {}
    for name, s in specs.items():
        buf = np.zeros(s.shape, np.float32)
        buf[:, :, :PROMPT] = np.asarray(jc[name], np.float32)
        jcache[name] = jnp.asarray(buf, jnp.bfloat16)
        tcache[name] = torch.as_tensor(buf).to(torch.bfloat16)
    nxt = np.asarray(jnp.argmax(jl, -1), np.int32)[:, None]
    lens = np.full((2,), PROMPT, np.int32)
    jd, jnew = jax.jit(lambda p, b, c: jmodel.decode_fn(p, cfg, b, c, jctx))(
        world["jparams"], {"tokens": jnp.asarray(nxt),
                           "lengths": jnp.asarray(lens)}, jcache)
    with torch.inference_mode():
        td, tnew = tmodel.decode_fn(
            world["tparams"], tcfg,
            {"tokens": torch.as_tensor(nxt).long(),
             "lengths": torch.as_tensor(lens)}, tcache, tctx)
    assert tnew["k"] is tcache["k"]              # written in place
    assert _rel(td, jd) <= tol
    for name in ("k", "v"):
        assert _rel(tnew[name][:, :, PROMPT], jnew[name][:, :, PROMPT]) <= tol


@pytest.mark.parametrize("impl", ["pallas", "blockwise"])
def test_serve_engine_generate_matches_jax(world, impl):
    cfg, tcfg = world["cfg"], world["tcfg"]
    toks = world["tokens"]
    jres = JEngine(cfg, world["jparams"],
                   recipe=Recipe(remat="none", attn_impl=impl),
                   max_seq=PROMPT + NEW + 8).generate(toks, NEW)
    tres = TEngine(tcfg, world["tparams"],
                   recipe=TRecipe(remat="none", attn_impl=impl),
                   max_seq=PROMPT + NEW + 8, device="cpu").generate(toks, NEW)
    assert tres.tokens.shape == jres.tokens.shape == (2, PROMPT + NEW)
    assert tres.tokens.dtype == np.int32 and tres.steps == NEW
    assert (tres.tokens[:, :PROMPT] == toks).all()
    jl, _ = jax.jit(lambda p, b: jmodel.prefill_fn(
        p, cfg, b, ShardingCtx(None, Recipe(remat="none", attn_impl=impl))))(
        world["jparams"], {"tokens": jnp.asarray(toks)})
    assert _rel(tres.prefill_logits, jl) <= _tol(world["dtype"])
    if world["dtype"] == "float32":
        np.testing.assert_array_equal(tres.tokens, jres.tokens)


def test_params_from_jax_keeps_keys_and_stacked_layout():
    cfg = reduced(ARCHS["starcoder2-3b"])
    tree = jax.tree.map(np.asarray, jinit(cfg, jax.random.PRNGKey(3)))
    tp = convert.params_from_jax(tree, device="cpu", dtype=torch.bfloat16)
    defs = tparams.param_defs(treduced(TARCHS["starcoder2-3b"]))

    def walk(d, t, j):
        assert set(d) == set(t) == set(j)
        for k in d:
            if isinstance(d[k], dict):
                walk(d[k], t[k], j[k])
            else:
                assert tuple(t[k].shape) == d[k].shape == j[k].shape
                assert t[k].dtype == torch.bfloat16
                np.testing.assert_array_equal(
                    t[k].float().numpy(),
                    np.asarray(jnp.asarray(j[k], jnp.bfloat16), np.float32))

    walk(defs, tp, tree)
    assert tp["blocks"]["wq"].shape[0] == cfg.num_layers


def test_init_params_draws_each_layer_and_matches_defs():
    tcfg = treduced(TARCHS["yi-34b"])
    gen = torch.Generator().manual_seed(0)
    p = tparams.init_params(tcfg, gen, dtype=torch.bfloat16, device="cpu")
    assert p["blocks"]["w_gate"].dtype == torch.bfloat16
    assert p["blocks"]["w_gate"].shape == (2, 128, 256)
    w = p["blocks"]["wq"].float()
    assert not torch.equal(w[0], w[1])           # layers drawn separately
    assert abs(float(w.std()) - 128 ** -0.5) < 0.1 * 128 ** -0.5
    assert float(p["embed"].float().std()) == pytest.approx(0.02, rel=0.1)
    assert torch.equal(p["blocks"]["ln1"], torch.ones(2, 128,
                                                      dtype=torch.bfloat16))
    again = tparams.init_params(tcfg, torch.Generator().manual_seed(0),
                                dtype=torch.bfloat16, device="cpu")
    assert torch.equal(again["blocks"]["w_down"], p["blocks"]["w_down"])


@pytest.fixture
def one_rank_mesh():
    """A (1, 1) ("data", "model") mesh of a fake one-rank world."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=1)
    try:
        yield init_device_mesh("cpu", (1, 1), mesh_dim_names=("data",
                                                             "model"))
    finally:
        dist.destroy_process_group()


def test_sharding_ctx_is_single_device(one_rank_mesh):
    """Without a mesh the context is the single-device no-op; a (1, 1)
    mesh, refused before the distributed slice, is accepted and gives the
    mesh-less numbers: no spec entry, every placement replicated, the same
    loss."""
    from torch.distributed.tensor import Replicate

    from repro_torch.distributed.elastic import reshard_params
    assert TRecipe() == TRecipe(**{f.name: getattr(Recipe(), f.name)
                                   for f in dataclasses.fields(Recipe)})
    x = torch.ones(2)
    assert TCtx().constrain(x, "batch") is x
    ctx = TCtx(mesh=one_rank_mesh, recipe=TRecipe(remat="none"))
    assert ctx.spec((4, 8), ("batch", "heads")) == (None, None)
    y = ctx.constrain(x, "batch")
    assert y.placements == (Replicate(), Replicate())
    assert torch.equal(y.full_tensor(), x)
    tcfg = dataclasses.replace(treduced(TARCHS["starcoder2-3b"]),
                               dtype="float32")
    params = tparams.init_params(tcfg, torch.Generator().manual_seed(0),
                                 device="cpu")
    tokens = torch.randint(0, tcfg.vocab_size, (2, 17),
                           generator=torch.Generator().manual_seed(1))
    want = tmodel.loss_fn(params, tcfg, {"tokens": tokens},
                          TCtx(None, ctx.recipe))
    got = tmodel.loss_fn(reshard_params(params, tcfg, one_rank_mesh,
                                        ctx.recipe),
                         tcfg, {"tokens": tokens}, ctx)
    assert float(got.full_tensor()) == float(want)


def test_configs_are_copies_of_the_jax_ones():
    assert set(TARCHS) == set(ARCHS)
    for name in ARCHS:
        assert dataclasses.asdict(TARCHS[name]) == dataclasses.asdict(
            ARCHS[name])
        assert dataclasses.asdict(treduced(TARCHS[name])) == \
            dataclasses.asdict(reduced(ARCHS[name]))
        assert TARCHS[name].param_count() == ARCHS[name].param_count()


# ---------------------------------------------------------------------------
# CAM on the serving plane: KV-pool planner and paged pool
# ---------------------------------------------------------------------------

MIXES = [
    (dict(n_requests=16, shared_prefix=512, mean_context=1024,
          decode_steps=12, kv_bytes_per_token=1024), 6 * 2**20, 0.0),
    (dict(n_requests=64, shared_prefix=2048, mean_context=8192,
          decode_steps=128, kv_bytes_per_token=4096), 8 * 2**30, 4 * 2**30),
    (dict(n_requests=32, shared_prefix=1024, mean_context=4096,
          decode_steps=64, kv_bytes_per_token=2048), 2 * 2**30, 1 * 2**30),
    (dict(n_requests=32, shared_prefix=1024, mean_context=4096,
          decode_steps=64, kv_bytes_per_token=2048), 4 * 2**30, 1 * 2**30),
    (dict(n_requests=32, shared_prefix=1024, mean_context=4096,
          decode_steps=64, kv_bytes_per_token=2048), 8 * 2**30, 1 * 2**30),
]


@pytest.mark.parametrize("mix,budget,weights", MIXES)
@pytest.mark.parametrize("scheduling,policy", [
    ("round_robin", "lru"), ("irm", "lru"), ("irm", "fifo"), ("irm", "lfu")])
def test_plan_kv_pool_matches_jax(mix, budget, weights, scheduling, policy):
    kw = dict(hbm_budget_bytes=budget, weight_bytes=weights, policy=policy,
              scheduling=scheduling)
    j = jplan.plan_kv_pool(jplan.RequestMix(**mix), **kw)
    t = tplan.plan_kv_pool(tplan.RequestMix(**mix), device="cpu", **kw)
    assert set(t.candidates) == set(j.candidates)

    def miss_scale(bt):     # cost = (1 - h) * refs/step * bytes/block
        _, refs = jplan.block_popularity(jplan.RequestMix(**mix), bt)
        return refs * bt * mix["kv_bytes_per_token"]

    for bt, cost in j.candidates.items():     # hit rates within 1e-6
        assert abs(t.candidates[bt] - cost) <= 1e-6 * miss_scale(bt)
    if t.block_tokens == j.block_tokens:
        assert t.pool_blocks == j.pool_blocks
        assert abs(t.hit_rate - j.hit_rate) <= 1e-6
    else:        # the winners tie to float32 resolution
        assert abs(j.candidates[t.block_tokens] - j.candidates[
            j.block_tokens]) <= 2e-6 * miss_scale(t.block_tokens)


def test_paged_pool_replay_matches_jax():
    mix = dict(n_requests=16, shared_prefix=512, mean_context=1024,
               decode_steps=12, kv_bytes_per_token=1024)
    rng = np.random.default_rng(0)
    schedule = [(int(r), mix["shared_prefix"], mix["mean_context"])
                for _ in range(mix["decode_steps"])
                for r in rng.permutation(mix["n_requests"])]
    refs = tkv.BlockTrace(64).decode_trace(schedule)
    assert refs == jkv.BlockTrace(64).decode_trace(schedule)
    for policy in ("lru", "fifo", "lfu"):
        tp, jp = (mod.PagedKVPool(100, 64, 64 * 1024, policy)
                  for mod in (tkv, jkv))
        for r in refs:
            assert tp.reference(r) == jp.reference(r)
        assert (tp.hit_rate, tp.transfer_bytes) == (jp.hit_rate,
                                                    jp.transfer_bytes)
    probs_t, rps_t = tplan.block_popularity(tplan.RequestMix(**mix), 64)
    probs_j, rps_j = jplan.block_popularity(jplan.RequestMix(**mix), 64)
    np.testing.assert_array_equal(probs_t, probs_j)
    assert rps_t == rps_j
    assert tplan.structural_hit_rate(tplan.RequestMix(**mix), 64, 40) == \
        jplan.structural_hit_rate(jplan.RequestMix(**mix), 64, 40)


def test_launcher_prints_generation_and_the_jax_kv_plan(capsys):
    from repro_torch.launch import serve as tserve

    tserve.main(["--device", "cpu", "--batch", "2", "--prompt-len", "8",
                 "--new-tokens", "2"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("arch=yi-34b: generated 2 tokens/seq for 2 "
                               "seqs; prefill=")
    full = ARCHS["yi-34b"]
    kv_bpt = 2 * full.num_layers * full.num_kv_heads * full.head_dim * 2
    plan = jplan.plan_kv_pool(
        jplan.RequestMix(n_requests=64, shared_prefix=2048,
                         mean_context=8192, decode_steps=256,
                         kv_bytes_per_token=kv_bpt),
        hbm_budget_bytes=16 * 2**30, weight_bytes=full.param_count() * 2 / 256)
    assert lines[1] == (
        f"CAM KV plan (yi-34b): block={plan.block_tokens} tokens, "
        f"pool={plan.pool_blocks} blocks, est hit={plan.hit_rate:.3f}, "
        f"est transfer/step={plan.transfer_bytes_per_step/2**20:.2f} MiB")
