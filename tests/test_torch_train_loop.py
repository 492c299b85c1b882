"""The port's training loop against the JAX package (CPU): the train step,
the token pipeline, checkpoints and the Supervisor, and the ``train_lm``
twin.

* Three steps of ``make_train_step`` on reduced starcoder2 in float32 at
  microbatch 1 and 2 (scan and unrolled accumulation) with float32 and
  bfloat16 gradient accumulation, and reduced qwen2-vl at microbatch 2
  (``positions_3d`` splits on its axis 1): loss and ``lr`` within rtol
  1e-5, ``grad_norm`` within rtol 1e-5 and every parameter leaf within
  1e-4 of its max-abs.  A bfloat16 accumulator rounds the packages'
  float32 gradients, which differ in their last bits, so some entries
  part by one ulp, and where two microbatches cancel the sum is rounding
  noise whose sign Adam's first steps turn into a whole +-lr update.
  There ``grad_norm`` is held to one bf16 rounding (2**-8), and at most
  1 in 1,000 entries of a leaf may pass 1e-4 of its max-abs, each within
  the two opposite updates of three steps (6 lr).
* ``TokenPipeline`` batches and host shards bit-equal for the dense, audio
  and VLM families.
* Mirrors of ``tests/test_distributed.py`` (checkpoint roundtrip, atomic
  save, failure recovery bitwise on the CPU, auto-resume, straggler
  flagging), a bfloat16 leaf through a checkpoint, and checkpoints of
  float32 and int8 training states written by each package restoring in
  the other and training on to the same loss (rtol 1e-5).
* The twin of ``examples/train_lm.py --smoke`` on JAX's seed-0 weights
  reproduces the example's losses step by step and passes its gate.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.data.pipeline import TokenPipeline as JPipeline
from repro.distributed import checkpoint as jck
from repro.distributed.fault_tolerance import Supervisor as JSupervisor
from repro.launch.train import build_trainer as jbuild
from repro.models.params import init_params as jinit
from repro.train import optimizer as jopt
from repro.train import train_step as jts
from repro_torch import convert
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.distributed import checkpoint as ck
from repro_torch.distributed.fault_tolerance import (FailureInjector,
                                                     Supervisor)
from repro_torch.launch import train_lm
from repro_torch.launch.train import build_trainer
from repro_torch.train import optimizer as topt
from repro_torch.train import train_step as tts

from _torch_train import (Recipe, TRecipe, configs, flat, perturbed_tree,
                          pipeline, rel_max, to_numpy)

OPT = dict(lr=1e-3, warmup_steps=2, total_steps=20)


def _jax_state(cfg, tree, recipe, opt_cfg):
    params = jax.tree.map(jnp.asarray, tree)
    return {"params": params,
            "opt_state": jts.init_opt_state(params, cfg, recipe, opt_cfg)}


def _torch_state(tcfg, tree, recipe, opt_cfg):
    params = convert.params_from_jax(tree, device="cpu")
    return {"params": params,
            "opt_state": tts.init_opt_state(params, tcfg, recipe, opt_cfg)}


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------

STEP_CASES = [("starcoder2-3b", mb, unroll, gdt)
              for gdt in ("float32", "bfloat16")
              for mb, unroll in ((1, False), (2, False), (2, True))] + [
    ("qwen2-vl-7b", 2, False, "float32")]


@pytest.mark.parametrize("arch,mb,unroll,gdt", STEP_CASES)
def test_train_steps_match_jax(arch, mb, unroll, gdt):
    cfg, tcfg = configs(arch)
    tree = perturbed_tree(cfg)
    kw = dict(remat="block", microbatch=mb, unroll_microbatches=unroll,
              grad_dtype=gdt)
    jo, to = jopt.AdamWConfig(**OPT), topt.AdamWConfig(**OPT)
    jstep = jax.jit(jts.make_train_step(cfg, Recipe(**kw), None, jo))
    tstep = tts.make_train_step(tcfg, TRecipe(**kw), None, to)
    js = _jax_state(cfg, tree, Recipe(**kw), jo)
    ts = _torch_state(tcfg, tree, TRecipe(**kw), to)
    pipe = pipeline(cfg, 4, 32, seed=1)
    tol = 2.0 ** -8 if gdt == "bfloat16" else 1e-5
    for step in range(3):
        batch = pipe.batch_for_step(step)
        jp, jopt_state, jm = jstep(js["params"], js["opt_state"],
                                   {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        js = {"params": jp, "opt_state": jopt_state}
        tp, topt_state, tm = tstep(ts["params"], ts["opt_state"],
                                   {k: torch.as_tensor(v)
                                    for k, v in batch.items()})
        ts = {"params": tp, "opt_state": topt_state}
        for name, rtol in (("loss", 1e-5), ("lr", 1e-5),
                           ("grad_norm", tol)):
            np.testing.assert_allclose(float(tm[name]), float(jm[name]),
                                       rtol=rtol, err_msg=(step, name))
    assert int(ts["opt_state"]["step"]) == 3
    tflat = flat(ts["params"])
    for path, p in flat(js["params"]).items():
        if gdt == "float32":
            assert rel_max(tflat[path], p) <= 1e-4, path
            continue
        p = to_numpy(p)
        d = np.abs(to_numpy(tflat[path]) - p)
        assert (d > 1e-4 * np.abs(p).max()).mean() <= 1e-3, path
        assert d.max() <= 2 * 3 * OPT["lr"], path


def test_split_microbatches_matches_jax():
    cfg, _ = configs("qwen2-vl-7b")
    batch = pipeline(cfg, 4, 8).batch_for_step(0)
    want = jts.split_microbatches({k: jnp.asarray(v)
                                   for k, v in batch.items()}, 2)
    got = tts.split_microbatches({k: torch.as_tensor(v)
                                  for k, v in batch.items()}, 2)
    for k in batch:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    with pytest.raises(ValueError, match="does not split"):
        tts.split_microbatches({"tokens": torch.zeros(3, 4)}, 2)


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


def test_train_step_refuses_a_mesh(one_rank_mesh):
    """A mesh, refused before the distributed slice, is accepted: on a
    (1, 1) mesh two steps give the mesh-less losses, norms and parameters
    to the bit.  The compressed recipe's ``ef`` keys are JAX's."""
    cfg, tcfg = configs("starcoder2-3b")
    opt = topt.AdamWConfig(**OPT)
    pipe = pipeline(cfg, 4, 32, seed=1)
    out = []
    for mesh in (None, one_rank_mesh):
        state = _torch_state(tcfg, perturbed_tree(cfg), TRecipe(), opt)
        if mesh is not None:
            state = tts.shard_state(state, tcfg, TRecipe(), mesh, "float32")
        step = tts.make_train_step(tcfg, TRecipe(), mesh, opt)
        ms = []
        for i in range(2):
            p, o, m = step(state["params"], state["opt_state"],
                           {k: torch.as_tensor(v)
                            for k, v in pipe.batch_for_step(i).items()})
            state = {"params": p, "opt_state": o}
            ms.append((float(m["loss"]), float(m["grad_norm"])))
        out.append((ms, {k: v.full_tensor() if mesh is not None else v
                         for k, v in flat(state["params"]).items()}))
    assert out[1][0] == out[0][0]
    for k, v in out[0][1].items():
        assert torch.equal(out[1][1][k], v), k
    tree = perturbed_tree(cfg)
    state = tts.init_opt_state(convert.params_from_jax(tree, device="cpu"),
                               tcfg, TRecipe(compress_pod_grads=True),
                               topt.AdamWConfig())
    jstate = jts.init_opt_state(jax.tree.map(jnp.asarray, tree), cfg,
                                Recipe(compress_pod_grads=True),
                                jopt.AdamWConfig())
    assert set(flat(state["ef"])) == set(flat(jstate["ef"]))
    assert not any(x.any() for x in flat(state["ef"]).values())


# ---------------------------------------------------------------------------
# The token pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["starcoder2-3b", "musicgen-medium",
                                  "qwen2-vl-7b"])
def test_token_pipeline_bit_equal(arch):
    cfg, _ = configs(arch)
    kw = dict(num_codebooks=cfg.num_codebooks,
              vlm_tokens=cfg.num_vision_tokens if cfg.family == "vlm" else 0,
              patch_dim=cfg.vision_patch_dim)
    jp = JPipeline(cfg.vocab_size, 4, 16, seed=5, **kw)
    tp = TokenPipeline(cfg.vocab_size, 4, 16, seed=5, **kw)
    for step in range(4):
        want, got = jp.batch_for_step(step), tp.batch_for_step(step)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
        for rank in range(2):
            ws, gs = jp.host_shard(want, rank, 2), tp.host_shard(got, rank, 2)
            for k in want:
                np.testing.assert_array_equal(gs[k], ws[k])


# ---------------------------------------------------------------------------
# Checkpoints and the Supervisor (mirrors of tests/test_distributed.py)
# ---------------------------------------------------------------------------

TCFG = configs("starcoder2-3b")[1]
TOPT = topt.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20)


def _fresh_state(seed=0):
    gen = torch.Generator().manual_seed(seed)
    from repro_torch.models.params import init_params
    params = init_params(TCFG, gen, device="cpu")
    recipe = TRecipe(remat="none")
    return {"params": params,
            "opt_state": tts.init_opt_state(params, TCFG, recipe, TOPT)}, \
        recipe


def test_checkpoint_roundtrip(tmp_path):
    state, _ = _fresh_state()
    state["compute"] = {"w": state["params"]["embed"].to(torch.bfloat16)}
    path = ck.save_checkpoint(str(tmp_path), 3, state)
    assert os.path.exists(os.path.join(path, "meta.json"))
    step, trees = ck.restore_checkpoint(str(tmp_path))
    assert step == 3
    for name in state:
        want, got = flat(state[name]), flat(trees[name])
        assert set(got) == set(want)
        for k, x in want.items():
            assert got[k].dtype == x.dtype and got[k].device.type == "cpu"
            assert torch.equal(got[k], x), (name, k)


def test_checkpoint_atomic_no_partial(tmp_path):
    state, _ = _fresh_state()
    ck.save_checkpoint(str(tmp_path), 1, state)
    # a stale .tmp dir (simulated crash mid-save) must be ignored
    os.makedirs(os.path.join(str(tmp_path), "step_00000002.tmp"))
    assert ck.latest_step(str(tmp_path)) == 1


def test_failure_recovery_bitwise_equivalent(tmp_path):
    """Training WITH an injected failure + restart gives exactly the final
    params of an uninterrupted run (deterministic pipeline, CPU)."""
    pipe = TokenPipeline(TCFG.vocab_size, 4, 32, seed=1)
    state_a, recipe = _fresh_state()
    step_fn = build_trainer(TCFG, recipe, TOPT, device="cpu")
    sup_a = Supervisor(step_fn, state_a, pipe.batch_for_step,
                       str(tmp_path / "a"), ckpt_every=4)
    res_a = sup_a.run(10)
    state_b, _ = _fresh_state()
    sup_b = Supervisor(step_fn, state_b, pipe.batch_for_step,
                       str(tmp_path / "b"), ckpt_every=4,
                       injector=FailureInjector(fail_at=(6,)))
    res_b = sup_b.run(10)
    assert res_b["restarts"] == 1 and res_b["final_step"] == 10
    assert res_b["losses"][-1] == res_a["losses"][-1]
    for k, a in flat(sup_a.state).items():
        assert torch.equal(a, flat(sup_b.state)[k]), k


def test_auto_resume_from_latest(tmp_path):
    pipe = TokenPipeline(TCFG.vocab_size, 4, 32, seed=2)
    state, recipe = _fresh_state()
    step_fn = build_trainer(TCFG, recipe, TOPT, device="cpu")
    Supervisor(step_fn, state, pipe.batch_for_step, str(tmp_path),
               ckpt_every=5).run(5)           # leaves step_5 checkpoint
    state2, _ = _fresh_state(seed=9)  # different init — must be overridden
    res = Supervisor(step_fn, state2, pipe.batch_for_step, str(tmp_path),
                     ckpt_every=5).run(8)
    assert res["final_step"] == 8
    assert len(res["losses"]) == 3   # only steps 5..7 executed


def test_straggler_flagging(tmp_path):
    """A step that takes 2.5x the median is flagged.  The step is a stub:
    straggler flagging is the Supervisor's alone, and an eager CPU train
    step's own time follows the machine's load (under six test workers a
    1 s delay stopped standing out), where the JAX mirror times a dispatch
    that returns before its step has computed."""
    state, _ = _fresh_state()
    flagged = []
    sup = Supervisor(lambda st, batch: (st, {"loss": torch.zeros(())}),
                     state, lambda step: {}, str(tmp_path), ckpt_every=100,
                     straggler_factor=2.5,
                     injector=FailureInjector(delays={8: 1.0}),
                     on_straggler=flagged.append)
    res = sup.run(10)
    assert 8 in flagged and res["stragglers"] == flagged


@pytest.mark.parametrize("moment_dtype", ["float32", "int8"])
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoint_restores_across_packages(tmp_path, writer, moment_dtype):
    """Four steps in one package, checkpointed; the other package resumes
    from the checkpoint and trains step 4 to the loss the writer's own
    uninterrupted run reaches there."""
    cfg, tcfg = configs("starcoder2-3b")
    tree = perturbed_tree(cfg)
    recipe = dict(remat="block")
    jo = jopt.AdamWConfig(moment_dtype=moment_dtype, **OPT)
    to = topt.AdamWConfig(moment_dtype=moment_dtype, **OPT)
    jpipe = JPipeline(cfg.vocab_size, 4, 32, seed=4)
    tpipe = TokenPipeline(cfg.vocab_size, 4, 32, seed=4)
    jstep = jbuild(cfg, Recipe(**recipe), jo)
    tstep = build_trainer(tcfg, TRecipe(**recipe), to, device="cpu")
    sups = {
        "jax": lambda d: JSupervisor(
            jstep, _jax_state(cfg, tree, Recipe(**recipe), jo),
            jpipe.batch_for_step, str(d), ckpt_every=100),
        "torch": lambda d: Supervisor(
            tstep, _torch_state(tcfg, tree, TRecipe(**recipe), to),
            tpipe.batch_for_step, str(d), ckpt_every=100)}
    reader = "torch" if writer == "jax" else "jax"
    whole = sups[writer](tmp_path / "whole").run(5)["losses"]
    sups[writer](tmp_path / "shared").run(4)
    resumed = sups[reader](tmp_path / "shared").run(5)
    assert len(resumed["losses"]) == 1 and resumed["final_step"] == 5
    np.testing.assert_allclose(resumed["losses"][0], whole[4], rtol=1e-5)
    # and the reader's checkpoint of step 5 restores in the writer
    _, trees = (ck.restore_checkpoint(str(tmp_path / "shared"))
                if writer == "torch" else
                jck.restore_checkpoint(str(tmp_path / "shared")))
    assert int(np.asarray(trees["opt_state"]["step"])) == 5


# ---------------------------------------------------------------------------
# The train_lm twin
# ---------------------------------------------------------------------------

def test_train_lm_twin_reproduces_the_example_smoke(tmp_path):
    """``examples/train_lm.py --smoke`` in JAX (weights from PRNGKey(0),
    the pipeline at seed 0) and the twin's ``--smoke`` on the same
    weights: the same losses step by step (2e-2, bf16 compute), and the
    example's gate, the last loss below the first."""
    cfg, steps, batch, seq = train_lm.config(smoke=True)
    jcfg = dataclasses.replace(
        get_config("starcoder2-3b"), **{f: getattr(cfg, f) for f in (
            "num_layers", "d_model", "num_heads", "num_kv_heads", "d_ff",
            "vocab_size", "head_dim")})
    jrecipe = Recipe(remat="block", microbatch=2)
    jo = jopt.AdamWConfig(lr=6e-4, warmup_steps=20, total_steps=steps)
    tree = jax.tree.map(np.asarray, jinit(jcfg, jax.random.PRNGKey(0)))
    state = _jax_state(jcfg, tree, jrecipe, jo)
    want = JSupervisor(jbuild(jcfg, jrecipe, jo), state,
                       JPipeline(jcfg.vocab_size, batch, seq,
                                 seed=0).batch_for_step,
                       str(tmp_path), ckpt_every=25).run(steps)["losses"]
    assert want[-1] < want[0]
    rec = train_lm.run(smoke=True, seed=0, torch_device="cpu",
                       params=convert.params_from_jax(tree, device="cpu"))
    assert rec["final_step"] == steps and rec["restarts"] == 0
    np.testing.assert_allclose(rec["losses"], want, rtol=2e-2)
    assert rec["loss_decreasing"]
