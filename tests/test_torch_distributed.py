"""The port's multi-device layer against the JAX package (CPU).

A gloo world of four processes (``_torch_mesh.py``) and a JAX process with
four host devices (``_jax_mesh_ref.py``) run the same cases side by side
once for the module:

* placements — each rank's index range (``compute_local_shape_and_global_
  offset``) equals that of JAX's shard on the device at the same mesh
  coordinate, tuple entries such as ``("pod", "data")`` included;
* ``_pod_gather_mean`` over a two-pod group against JAX's under
  ``jax.vmap(..., axis_name="pod")`` (float32 rounding), and the tree
  version (a layer slice at a time) against the leaf one;
* ``dtensor_mm`` (the DTensor rule of the float32-accumulating products)
  against plain products and their gradients;
* two train steps of reduced float32 starcoder2-3b and qwen2-moe-a2.7b on
  (data 2, model 2) and of the pod-compressed step on (pod 2, data 1,
  model 2) against JAX's steps on the same mesh: loss and grad norm
  within 1e-5, every parameter leaf within 1e-4 of its max-abs
  (``tests/test_torch_train_loop.py``'s bounds); in the compressed step
  an int8 rounding flip moves an entry by up to a whole lr, so there at
  most 1 in 1,000 entries of a leaf may pass 1e-4, each within the two
  opposite updates of its steps (ROADMAP Queue 3);
* a checkpoint written on a 2 x 2 mesh restores bit-equal without one, and
  one written without a mesh places bit-equal on one;
* three decode steps of float32 reduced starcoder2-3b (float32 and int8
  caches), qwen2-moe-a2.7b and zamba2-2.7b on (data 2, model 2), the cache
  split by batch and by length, against the same steps without a mesh:
  logits and final caches within 1e-5 of their max-abs (float32 sums in
  another order), int8 cache values equal.

In this process: int8 quantization bit-equal to JAX, error feedback as
``tests/test_distributed.py``, ``reshard_params`` without a mesh, every
family's loss and gradients on a one-rank mesh equal to the mesh-less
ones, the Supervisor restarting on a one-rank mesh, ``collective_bytes``
of a known all-gather, and ``ServeEngine`` refusing a mesh.
"""
import json
import os
import pathlib
import subprocess
import sys
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import compression as jcomp
from repro_torch import convert
from repro_torch.distributed import checkpoint as ck
from repro_torch.distributed import compression
from repro_torch.distributed.elastic import reshard_params
from repro_torch.train.optimizer import leaves as opt_leaves
from repro_torch.train.optimizer import map_tree

from _mesh_cases import DECODE_CASES, OPT, PLACEMENTS, STEP_CASES, STEPS
from _torch_train import (TRecipe, configs, flat, perturbed_tree, pipeline,
                          rel_max)

ROOT = pathlib.Path(__file__).resolve().parents[1]
TIMEOUT = 900      # the whole gloo world and the JAX process, each


def _spawn_world(tmp, src, dst):
    """The four gloo ranks of ``_torch_mesh.worker``, stopped at
    ``TIMEOUT``."""
    import torch.multiprocessing as mp

    from _torch_mesh import worker
    ctx = mp.start_processes(worker, args=(4, str(tmp / "pg"), str(src),
                                           str(dst)),
                             nprocs=4, join=False, start_method="spawn")
    deadline = time.monotonic() + TIMEOUT
    try:
        while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
            if time.monotonic() > deadline:
                raise TimeoutError("the gloo world did not finish")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(port's results, JAX's results, work dir) of the shared cases."""
    tmp = tmp_path_factory.mktemp("mesh")
    inp = {}
    for case, arch, *_ in STEP_CASES:
        cfg, _ = configs(arch)
        for k, v in flat(perturbed_tree(cfg)).items():
            inp[f"init/{case}/{k}"] = np.asarray(v)
        pipe = pipeline(cfg, 4, 32, seed=1)
        for i in range(2):
            for k, v in pipe.batch_for_step(i).items():
                inp[f"batch/{case}/{i}/{k}"] = v
    rng = np.random.default_rng(4)
    inp["pod/leaf"] = rng.standard_normal((2, 8, 6)).astype(np.float32)
    inp["pod/ef"] = 0.01 * rng.standard_normal((2, 8, 6)).astype(np.float32)
    src = tmp / "in.npz"
    np.savez(src, **inp)
    # a checkpoint written without a mesh, for the ranks to place
    _, tcfg = configs("starcoder2-3b")
    plain = convert.params_from_jax(
        {k[len("init/dense/"):]: v for k, v in inp.items()
         if k.startswith("init/dense/")}, device="cpu")
    ck.save_checkpoint(str(tmp / "plain"), 3,
                       {"params": ck.unflatten_tree(plain)})

    env = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}{os.pathsep}"
               f"{ROOT / 'tests'}", JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    ref = subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "_jax_mesh_ref.py"), str(src),
         str(tmp / "jax.npz")], env=env, cwd=str(ROOT),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        _spawn_world(tmp, src, tmp / "torch.npz")
        _, err = ref.communicate(timeout=TIMEOUT)
    finally:
        if ref.poll() is None:
            ref.kill()
    assert ref.returncode == 0, err[-3000:]
    return (dict(np.load(tmp / "torch.npz")), dict(np.load(tmp / "jax.npz")),
            tmp)


@pytest.mark.parametrize("i", range(len(PLACEMENTS)))
def test_placements_give_each_rank_jax_index_range(runs, i):
    got, want, _ = runs
    assert json.loads(str(got[f"placement/{i}"])) == \
        json.loads(str(want[f"placement/{i}"]))


def test_pod_gather_mean_matches_jax(runs):
    got, want, _ = runs
    for row in got["pod/mean"]:
        np.testing.assert_allclose(row, want["pod/mean"][0], rtol=1e-6,
                                   atol=1e-7)
    np.testing.assert_allclose(got["pod/new_ef"], want["pod/new_ef"],
                               rtol=1e-6, atol=1e-7)
    assert float(got["pod/tree_vs_leaf"]) == 0.0


def test_dtensor_mm_rule_matches_plain_products(runs):
    got, _, _ = runs
    assert float(got["mm/worst"]) <= 1e-5


@pytest.mark.parametrize("case", [c[0] for c in STEP_CASES])
def test_mesh_train_steps_match_jax(runs, case):
    got, want, _ = runs
    np.testing.assert_allclose(got[f"loss/{case}"], want[f"loss/{case}"],
                               rtol=1e-5)
    np.testing.assert_allclose(got[f"grad_norm/{case}"],
                               want[f"grad_norm/{case}"], rtol=1e-5)
    keys = [k for k in want if k.startswith(f"final/{case}/")]
    assert keys and set(keys) == {k for k in got
                                  if k.startswith(f"final/{case}/")}
    for k in keys:
        if case != "pod":
            assert rel_max(got[k], want[k]) <= 1e-4, k
            continue
        # int8 rounding: where g/scale sits on a half, the packages' last
        # float32 bit picks q, one scale apart, and Adam turns that into
        # up to a whole lr a step (ROADMAP Queue 3: 1 of 65,536 entries
        # of w_down and of w_up, 0.24 and 0.17 lr)
        d = np.abs(got[k] - want[k])
        assert (d > 1e-4 * np.abs(want[k]).max()).mean() <= 1e-3, k
        assert d.max() <= 2 * STEPS * OPT["lr"], k


def test_checkpoints_move_between_mesh_and_no_mesh(runs):
    got, _, tmp = runs
    assert float(got["ckpt/plain_to_mesh"]) == 0.0
    assert int(got["ckpt/plain_step"]) == 3
    step, trees = ck.restore_checkpoint(str(tmp / "from_mesh"))
    assert step == 7
    _, want = ck.restore_checkpoint(str(tmp / "plain"))
    flat_got, flat_want = flat(trees["params"]), flat(want["params"])
    assert set(flat_got) == set(flat_want)
    for k, v in flat_want.items():
        assert torch.equal(flat_got[k], v), k


# ---------------------------------------------------------------------------
# In this process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", [c[0] for c in DECODE_CASES])
def test_mesh_decode_matches_meshless(runs, case):
    port, _, _ = runs
    assert float(port[f"decode/{case}/logits"]) <= 1e-5
    # float leaves over their max-abs; int8 values in counts (must be 0)
    assert float(port[f"decode/{case}/cache"]) <= 1e-5


def test_int8_quantization_bit_equal_to_jax():
    rng = np.random.default_rng(0)
    for scale in (1.0, 1e-3, 0.0):
        g = (scale * rng.standard_normal((7, 33))).astype(np.float32)
        jq, js = jcomp.quantize_int8(jnp.asarray(g))
        q, s = compression.quantize_int8(torch.as_tensor(g))
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
        np.testing.assert_array_equal(
            compression.dequantize_int8(q, s).numpy(),
            np.asarray(jcomp.dequantize_int8(jq, js)))


def test_int8_quantization_error_feedback():
    rng = np.random.default_rng(0)
    g = torch.as_tensor(rng.standard_normal(1000), dtype=torch.float32)
    q, s = compression.quantize_int8(g)
    deq = compression.dequantize_int8(q, s)
    assert float((deq - g).abs().max()) <= float(s) * 0.5 + 1e-6
    ef, acc = torch.zeros_like(g), torch.zeros_like(g)
    for _ in range(50):
        mean, ef = compression._pod_gather_mean(g, ef, 1)
        acc = acc + mean
    np.testing.assert_allclose((acc / 50).numpy(), g.numpy(), atol=float(s))


def test_elastic_reshard_roundtrip(tmp_path):
    """Save, then restore onto mesh=None — values unchanged."""
    cfg, tcfg = configs("starcoder2-3b")
    params = convert.params_from_jax(perturbed_tree(cfg), device="cpu")
    ck.save_checkpoint(str(tmp_path), 0, {"params": params})
    _, trees = ck.restore_checkpoint(str(tmp_path))
    out = reshard_params(trees["params"], tcfg, None, TRecipe())
    for k, v in flat(params).items():
        assert torch.equal(flat(out)[k], v), k


@pytest.fixture
def one_rank():
    """A one-rank gloo world (file store) for a (1, 1) mesh."""
    import tempfile

    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group("gloo", init_method=f"file://{d}/pg",
                                rank=0, world_size=1)
        try:
            yield
        finally:
            dist.destroy_process_group()


def _one_mesh(names=("data", "model")):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cpu", (1,) * len(names), mesh_dim_names=names)


def test_models_run_on_a_one_rank_mesh(one_rank):
    """``loss_fn`` of every family on DTensor params of a (1, 1) mesh gives
    the mesh-less loss and gradients."""
    from repro_torch.distributed.sharding import ShardingCtx
    from repro_torch.models import model as tmodel
    mesh = _one_mesh()
    for arch in ("starcoder2-3b", "qwen2-moe-a2.7b", "qwen2-vl-7b",
                 "musicgen-medium", "rwkv6-3b", "zamba2-2.7b"):
        cfg, tcfg = configs(arch)
        tree = convert.params_from_jax(perturbed_tree(cfg), device="cpu")
        batch = {k: torch.as_tensor(v) for k, v in
                 pipeline(cfg, 2, 16).batch_for_step(0).items()}
        out = []
        for m in (None, mesh):
            ctx = ShardingCtx(m, TRecipe(remat="none"))
            params = reshard_params(map_tree(torch.clone, tree), tcfg, m,
                                    ctx.recipe)
            leaves = [x.requires_grad_() for _, x in opt_leaves(params)]
            with ctx.scope():
                loss = tmodel.loss_fn(params, tcfg, batch, ctx)
                loss.backward()
            out.append((float((loss.full_tensor() if m is not None else loss)
                              .detach()),
                        [x.grad.full_tensor() if m is not None else x.grad
                         for x in leaves]))
        assert out[1][0] == pytest.approx(out[0][0], rel=1e-6), arch
        for a, b in zip(out[1][1], out[0][1]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=arch)


def test_collective_bytes_of_a_known_all_gather():
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch import collectives
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        mesh = init_device_mesh("cpu", (4,), mesh_dim_names=("data",))
        x = DTensor.from_local(torch.zeros(2, 8), mesh, [Shard(0)],
                               run_check=False)
        with collectives.CollectiveLog() as log:
            x.redistribute(mesh, [Replicate()])
        assert collectives.collective_schedule(log) == [("all-gather", 256)]
        totals = collectives.collective_bytes(log)
        assert totals["all-gather"] == totals["total"] == 256
        assert set(totals) == {"all-gather", "all-reduce", "reduce-scatter",
                               "all-to-all", "collective-permute", "total"}
    finally:
        dist.destroy_process_group()


def test_supervisor_restarts_on_a_mesh(one_rank):
    """``train_lm`` through ``build_trainer(mesh=...)``: a failure at step
    4 restores the checkpoint's arrays onto the mesh and replays to the
    uninterrupted run's last loss."""
    from repro_torch.launch import train_lm
    mesh = _one_mesh()
    whole = train_lm.run(smoke=True, torch_device="cpu", mesh=mesh)
    faulted = train_lm.run(smoke=True, torch_device="cpu", mesh=mesh,
                           fail_at=(4,))
    assert (whole["restarts"], faulted["restarts"]) == (0, 1)
    assert faulted["final_step"] == whole["steps"]
    assert faulted["losses"][-1] == whole["losses"][-1]


def test_serve_engine_refuses_a_mesh():
    from repro_torch.configs import ARCHS as TARCHS
    from repro_torch.serve.engine import ServeEngine
    with pytest.raises(NotImplementedError, match="one device"):
        ServeEngine(TARCHS["starcoder2-3b"], {}, mesh=object(), device="cpu")
