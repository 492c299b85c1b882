"""The port's training math against the JAX package on shared weights (CPU).

* ``loss_fn`` and its gradients for every architecture of ``ARCHS`` at
  ``reduced`` size in float32 (the loss within rtol 1e-5, every gradient
  leaf within 1e-4 of its max-abs), and starcoder2 with a bfloat16 compute
  copy at 2e-2.  The batch is 2 x 64 tokens: rwkv6's JAX chunk form is
  finite there (ROADMAP Queue 3).  MoE runs in float32 only: bfloat16
  flips its routing (PERF.md §6).
* remat "none", "block" and "nested" give the same loss and gradients.
* AdamW, one update per moment dtype from the same non-zero moments:
  params and float32 moments rtol 1e-6, bfloat16 moments within one ulp,
  int8 values within +-1 and scales 1e-6 relative; ``cosine_schedule``
  and ``global_norm``.
* Neither attention kernel has a backward: the port's wrappers refuse
  inputs that require grad on every device, and JAX's gradient through
  its Pallas flash kernel fails.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS
from repro.data.pipeline import TokenPipeline
from repro.distributed.sharding import Recipe, ShardingCtx
from repro.models import model as jmodel
from repro.models.params import init_params as jinit
from repro.train import optimizer as jopt
from repro_torch.distributed.sharding import Recipe as TRecipe
from repro_torch.kernels import ops as tops
from repro_torch.models import attention as tattn
from repro_torch.train import optimizer as topt

from _torch_train import (configs, flat, jax_loss_and_grads, perturbed_tree,
                          pipeline, rel_max, to_numpy, to_torch,
                          torch_loss_and_grads)

SEQ = 64
CASES = [(a, "float32") for a in sorted(ARCHS)] + [("starcoder2-3b",
                                                     "bfloat16")]


@pytest.mark.parametrize("arch,dtype", CASES)
def test_loss_and_grads_match_jax(arch, dtype):
    cfg, tcfg = configs(arch, dtype)
    tree = perturbed_tree(cfg)
    batch = pipeline(cfg, 2, SEQ).batch_for_step(0)
    jl, jg = jax_loss_and_grads(cfg, tree, batch, Recipe(remat="block"))
    tl, tg = torch_loss_and_grads(tcfg, tree, batch, TRecipe(remat="block"))
    assert tl.dtype == torch.float32 and tl.shape == ()
    bf16 = dtype == "bfloat16"
    assert abs(float(tl) - float(jl)) <= (2e-2 if bf16 else 1e-5) * abs(
        float(jl))
    jflat = flat(jg)
    assert set(jflat) == set(tg)
    for path, g in jflat.items():
        assert tg[path].dtype == (torch.bfloat16 if bf16 else torch.float32)
        assert rel_max(tg[path], g) <= (2e-2 if bf16 else 1e-4), path


@pytest.mark.parametrize("arch", ["starcoder2-3b", "qwen2-moe-a2.7b",
                                  "rwkv6-3b", "zamba2-2.7b"])
def test_remat_policies_agree(arch):
    """Four layers, so "nested" makes two groups of two."""
    _, tcfg = configs(arch, num_layers=4)
    cfg, _ = configs(arch, num_layers=4)
    tree = perturbed_tree(cfg)
    batch = pipeline(cfg, 2, 32).batch_for_step(1)
    base_l, base_g = torch_loss_and_grads(tcfg, tree, batch,
                                          TRecipe(remat="none"))
    for remat in ("block", "nested"):
        l, g = torch_loss_and_grads(tcfg, tree, batch, TRecipe(remat=remat))
        assert abs(float(l) - float(base_l)) <= 1e-6 * abs(float(base_l))
        for path, x in g.items():
            assert rel_max(x, base_g[path]) <= 1e-6, (remat, path)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def _adam_world(moment_dtype):
    """Params, gradients and non-zero moments of reduced starcoder2, as a
    JAX opt_state and the same state in the port."""
    cfg, _ = configs("starcoder2-3b")
    tree = perturbed_tree(cfg)
    rng = np.random.default_rng(7)
    noise = lambda s: jax.tree.map(
        lambda a: (s * rng.standard_normal(a.shape)).astype(np.float32), tree)
    grads, m0, v0 = noise(0.3), noise(0.01), noise(1e-3)
    v0 = jax.tree.map(np.abs, v0)
    store = lambda t: jax.tree.map(
        lambda a: jopt._store(jnp.asarray(a), moment_dtype), t)
    jstate = {"m": store(m0), "v": store(v0),
              "step": jnp.asarray(3, jnp.int32)}
    return tree, grads, jstate


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16", "int8"])
def test_adamw_update_matches_jax(moment_dtype):
    tree, grads, jstate = _adam_world(moment_dtype)
    cfg = jopt.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20,
                           moment_dtype=moment_dtype)
    tcfg = topt.AdamWConfig(**dataclasses.asdict(cfg))
    jp, jo, jm = jopt.adamw_update(
        jax.tree.map(jnp.asarray, grads), jstate,
        jax.tree.map(jnp.asarray, tree), cfg, jopt.cosine_schedule(cfg))
    tparams, tstate = to_torch(tree), to_torch(jstate)
    tp, to, tm = topt.adamw_update(to_torch(grads), tstate, tparams, tcfg,
                                   topt.cosine_schedule(tcfg))
    assert tp is tparams and to is tstate        # updated in place
    assert int(to["step"]) == int(jo["step"]) == 4
    assert to["step"].dtype == torch.int32
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-7)
    for path, p in flat(jp).items():
        p = to_numpy(p)   # entries near 0 by cancellation: 1e-7 of max-abs
        np.testing.assert_allclose(to_numpy(flat(tp)[path]), p, rtol=1e-6,
                                   atol=1e-7 * np.abs(p).max(), err_msg=path)
    for name in ("m", "v"):
        got, want = flat(to[name]), flat(jo[name])
        assert set(got) == set(want)
        for path, j in want.items():
            t = got[path]
            if moment_dtype == "int8":
                assert t["q"].dtype == torch.int8
                assert np.abs(t["q"].numpy().astype(np.int32)
                              - np.asarray(j["q"], np.int32)).max() <= 1
                np.testing.assert_allclose(float(t["s"]), float(j["s"]),
                                           rtol=1e-6)
            elif moment_dtype == "bfloat16":
                assert t.dtype == torch.bfloat16
                j = to_numpy(j)
                ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(j),
                                                          1e-30))) - 7)
                assert (np.abs(to_numpy(t) - j) <= ulp).all(), (name, path)
            else:
                np.testing.assert_allclose(to_numpy(t), to_numpy(j),
                                           rtol=1e-6, atol=1e-12,
                                           err_msg=(name, path))


def test_adamw_init_matches_jax():
    cfg, _ = configs("starcoder2-3b")
    tree = perturbed_tree(cfg)
    for dt in ("float32", "bfloat16", "int8"):
        oc = jopt.AdamWConfig(moment_dtype=dt)
        js = jopt.adamw_init(jax.tree.map(jnp.asarray, tree), oc)
        ts = topt.adamw_init(to_torch(tree), topt.AdamWConfig(moment_dtype=dt))
        assert set(flat(ts["m"])) == set(flat(js["m"]))
        for path, j in flat(js["m"]).items():
            t = flat(ts["m"])[path]
            if dt == "int8":
                assert t["q"].dtype == torch.int8 and not t["q"].any()
                assert float(t["s"]) == float(j["s"])
            else:
                assert str(t.dtype).split(".")[1] == str(j.dtype)
                assert not t.any()


def test_cosine_schedule_and_global_norm_match_jax():
    cfg = jopt.AdamWConfig(lr=3e-4, warmup_steps=5, total_steps=8)
    tcfg = topt.AdamWConfig(lr=3e-4, warmup_steps=5, total_steps=8)
    jl, tl = jopt.cosine_schedule(cfg), topt.cosine_schedule(tcfg)
    for step in (0, 1, 5, 6, 8, 12):
        got = tl(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(jl(step)), rtol=1e-7)
    tree, grads, _ = _adam_world("float32")
    np.testing.assert_allclose(
        float(topt.global_norm(to_torch(grads))),
        float(jopt.global_norm(jax.tree.map(jnp.asarray, grads))), rtol=1e-6)


def test_leaves_walk_in_jax_order():
    tree = {"b": {"y": 1, "x": 2}, "a": 3, "c": {"q": 4, "s": 5}}
    assert [p for p, _ in topt.leaves(tree)] == [("a",), ("b", "x"),
                                                 ("b", "y"), ("c",)]
    assert [x for _, x in topt.leaves(tree)][:3] == jax.tree.leaves(tree)[:3]


# ---------------------------------------------------------------------------
# No backward kernel for attention, in either package
# ---------------------------------------------------------------------------

def _qkv(s, grad):
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, s, 4, 32, generator=g) for _ in range(3))
    return q.requires_grad_(grad), k, v


def test_attention_kernels_refuse_gradients():
    q, k, v = _qkv(300, True)
    with pytest.raises(ValueError, match="no backward kernel"):
        tops.flash_attention(q, k, v)
    with pytest.raises(ValueError, match="no backward kernel"):
        tattn.attention(q, k, v, impl="pallas")
    lengths = torch.tensor([5])
    with pytest.raises(ValueError, match="no backward kernel"):
        tops.decode_attention(q[:, :1], k, v, lengths)
    with pytest.raises(ValueError, match="no backward kernel"):
        tattn.decode_attention(q[:, :1], k, v, lengths, impl="pallas")
    # forward only is fine; blockwise differentiates
    with torch.no_grad():
        tops.flash_attention(q, k, v)
        tops.decode_attention(q[:, :1], k, v, lengths)
    tattn.attention(q, k, v, impl="blockwise").sum().backward()
    assert q.grad is not None


def test_pallas_training_raises_in_both_packages():
    """A 300-token batch reaches the flash path (past the 256-token dense
    cutoff): the port's trainer refuses it, and JAX's gradient through its
    Pallas kernel fails in the transpose, while blockwise trains."""
    cfg, tcfg = configs("starcoder2-3b")
    tree = jax.tree.map(np.asarray, jinit(cfg, jax.random.PRNGKey(0)))
    batch = TokenPipeline(cfg.vocab_size, 1, 300, 0).batch_for_step(0)
    with pytest.raises(ValueError, match="no backward kernel"):
        torch_loss_and_grads(tcfg, tree, batch, TRecipe(attn_impl="pallas"))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jparams = jax.tree.map(jnp.asarray, tree)
    ctx = ShardingCtx(None, Recipe(remat="none", attn_impl="pallas"))
    with pytest.raises(AssertionError):
        jax.value_and_grad(lambda p: jmodel.loss_fn(p, cfg, jbatch, ctx))(
            jparams)
    jl, _ = jax_loss_and_grads(cfg, tree, batch, Recipe(remat="none"))
    tl, _ = torch_loss_and_grads(tcfg, tree, batch, TRecipe(remat="none"))
    assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
