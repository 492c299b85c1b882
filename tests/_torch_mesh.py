"""The port's side of the multi-device parity tests: one rank of a gloo
world of four processes (``torch.multiprocessing``), started by
``tests/test_torch_distributed.py`` with the same ``IN.npz`` that
``_jax_mesh_ref.py`` reads.  Rank 0 writes ``OUT.npz``: each rank's mesh
coordinate and index range per placement case, ``_pod_gather_mean`` over
the pod group, the ``dtensor_mm`` rule against plain products, each step
case's losses, grad norms and final weights, the checkpoint checks, and
each decode case against the same steps without a mesh, and each serve
case's ``ServeEngine.generate`` on the mesh against the engine without
one, with the attention wrappers' calls counted.
"""
import dataclasses
import json
import os

import numpy as np
import torch
import torch.distributed as dist

from _mesh_cases import (DECODE_CASES, DECODE_LENGTHS, OPT, PLACEMENTS,
                         RECIPE, SERVE_CASES, SERVE_MAX_SEQ,
                         SERVE_NEW_TOKENS, STEP_CASES, STEPS)


def _mesh(shape, names):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cpu", shape, mesh_dim_names=names)


def _unflatten(flat, prefix):
    tree = {}
    for k, v in flat.items():
        if not k.startswith(prefix):
            continue
        parts = k[len(prefix):].split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = torch.as_tensor(v.copy())
    return tree


def _full(x):
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def placements(out):
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    from repro_torch.distributed.sharding import Recipe, ShardingCtx
    for i, (shape, names, gshape, spec) in enumerate(PLACEMENTS):
        mesh = _mesh(shape, names)
        pl = ShardingCtx(mesh, Recipe()).placements(spec)
        local, off = compute_local_shape_and_global_offset(gshape, mesh, pl)
        row = [list(mesh.get_coordinate()),
               [[o, o + n] for o, n in zip(off, local)]]
        rows = [None] * dist.get_world_size()
        dist.all_gather_object(rows, row)
        out[f"placement/{i}"] = np.asarray(json.dumps(sorted(rows)))


def pod_mean(inp, out):
    from repro_torch.distributed import compression
    from repro_torch.distributed.sharding import (Recipe, ShardingCtx,
                                                  place)
    mesh = _mesh((2, 1, 2), ("pod", "data", "model"))
    sub = mesh["data", "model"]
    p = mesh.get_local_rank("pod")
    sh = ShardingCtx(sub, Recipe()).sharding(inp["pod/leaf"].shape[1:],
                                            (None, "tp"))
    leaf = place(torch.as_tensor(inp["pod/leaf"][p]), sh)
    ef = place(torch.as_tensor(inp["pod/ef"][p]), sh)
    mean, new_ef = compression._pod_gather_mean(leaf, ef, 2,
                                                mesh.get_group("pod"))
    rows = [None] * dist.get_world_size()
    dist.all_gather_object(rows, (p, mean.full_tensor().numpy(),
                                  new_ef.full_tensor().numpy()))
    out["pod/mean"] = np.stack([r[1] for r in rows])
    out["pod/new_ef"] = np.stack([r[2] for r in sorted(
        rows, key=lambda r: r[0])[::2]])
    # the in-place, slice-at-a-time tree version gives the same numbers
    sh3 = ShardingCtx(sub, Recipe()).sharding((3, 8, 6), (None, None, "tp"))
    stack = torch.as_tensor(np.stack([inp["pod/leaf"][p]] * 3))
    grads = {"blocks": {"w": place(stack, sh3)}}
    efs = {"blocks": {"w": place(torch.zeros_like(stack), sh3)}}
    compression.compressed_pod_mean(grads, efs, mesh)
    g0, e0 = compression._pod_gather_mean(
        place(stack, sh3), place(torch.zeros_like(stack), sh3), 2,
        mesh.get_group("pod"))
    out["pod/tree_vs_leaf"] = np.asarray(max(
        float((grads["blocks"]["w"].full_tensor()
               - g0.full_tensor()).abs().max()),
        float((efs["blocks"]["w"].full_tensor()
               - e0.full_tensor()).abs().max())))


def mm_rule(out):
    """``dtensor_mm`` against the plain product and its gradients, for
    operands split every way the rule knows on a (2, 2) mesh."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.models.layers import dtensor_mm
    mesh = _mesh((2, 2), ("data", "model"))
    gen = torch.Generator().manual_seed(5)
    worst = 0.0
    options = [Replicate(), Shard(0), Shard(1)]
    for nd in (2, 3):
        a = torch.randn((4,) * (nd - 2) + (8, 6), generator=gen)
        b = torch.randn((4,) * (nd - 2) + (6, 4), generator=gen)
        w = torch.randn((4,) * (nd - 2) + (8, 4), generator=gen)
        ref_a, ref_b = a.clone().requires_grad_(), b.clone().requires_grad_()
        (torch.matmul(ref_a, ref_b) * w).sum().backward()
        for pa in options:
            for pb in options:
                da = DTensor.from_local(a, mesh, [Replicate()] * 2,
                                        run_check=False).redistribute(
                    mesh, [pa, Shard(nd - 1)]).detach().requires_grad_()
                db = DTensor.from_local(b, mesh, [Replicate()] * 2,
                                        run_check=False).redistribute(
                    mesh, [Replicate(), pb]).detach().requires_grad_()
                y = dtensor_mm(da, db, torch.matmul)
                (y * DTensor.from_local(w, mesh, [Replicate()] * 2,
                                        run_check=False)).sum().backward()
                worst = max(worst,
                            float((y.full_tensor() - a @ b).abs().max()),
                            float((da.grad.full_tensor()
                                   - ref_a.grad).abs().max()),
                            float((db.grad.full_tensor()
                                   - ref_b.grad).abs().max()))
    out["mm/worst"] = np.asarray(worst)


def steps(inp, out):
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.distributed.elastic import reshard_params
    from repro_torch.distributed.sharding import Recipe
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train import train_step as ts
    for case, arch, shape, names, kw in STEP_CASES:
        cfg = dataclasses.replace(reduced(ARCHS[arch]), dtype="float32")
        recipe = Recipe(**RECIPE, **kw)
        opt = opt_mod.AdamWConfig(**OPT)
        mesh = _mesh(shape, names)
        ctx = ts.param_ctx(recipe, mesh)
        params = reshard_params(_unflatten(inp, f"init/{case}/"), cfg,
                                ctx.mesh, ctx.recipe)
        state = ts.init_opt_state(params, cfg, recipe, opt)
        step = ts.make_train_step(cfg, recipe, mesh, opt)
        losses, norms = [], []
        for i in range(STEPS):
            batch = _unflatten(inp, f"batch/{case}/{i}/")
            params, state, m = step(params, state, batch)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        out[f"loss/{case}"] = np.asarray(losses)
        out[f"grad_norm/{case}"] = np.asarray(norms)
        for path, x in opt_mod.leaves(params):
            out[f"final/{case}/" + "/".join(path)] = _full(x).numpy()


def decode(out):
    """Each decode case on a (2, 2) mesh against the same steps without
    one: the logits' and the final caches' largest differences, each over
    its max-abs (int8 values: the largest difference in counts)."""
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.distributed.elastic import reshard_params, reshard_tree
    from repro_torch.distributed.sharding import Recipe, ShardingCtx
    from repro_torch.models import model as tmodel
    from repro_torch.models.params import init_params
    mesh = _mesh((2, 2), ("data", "model"))
    b = len(DECODE_LENGTHS)
    for case, arch, kv in DECODE_CASES:
        cfg = dataclasses.replace(reduced(ARCHS[arch]), dtype="float32")
        shape = ShapeSpec("d", "decode", 16, b)
        gen = torch.Generator().manual_seed(3)
        host = init_params(cfg, gen, dtype=torch.float32, device="cpu")
        cache0 = {}
        for k, m in tmodel.cache_specs(cfg, shape,
                                       getattr(torch, kv)).items():
            x = torch.randn(m.shape, generator=gen)
            cache0[k] = (torch.clamp(torch.round(x * 40), -127, 127)
                         .to(torch.int8) if m.dtype == torch.int8 else
                         x.abs() * 0.02 + 0.01 if k.endswith("_scale")
                         else x)        # float caches in float32, as the model
        dims = tmodel.cache_dims(cfg)
        toks = torch.randint(0, cfg.vocab_size, (3, b, 1), generator=gen,
                             dtype=torch.int32)
        runs = []
        for m in (None, mesh):
            ctx = ShardingCtx(m, Recipe())
            params = reshard_params(host, cfg, m, ctx.recipe)
            cache = reshard_tree(
                {k: v.clone() for k, v in cache0.items()},
                {k: ctx.sharding(v.shape, dims[k])
                 for k, v in cache0.items()})
            logits = []
            for i in range(3):
                batch = {"tokens": toks[i], "lengths": torch.tensor(
                    DECODE_LENGTHS, dtype=torch.int32) + i}
                batch = reshard_tree(batch, {
                    k: ctx.sharding(v.shape, d) for (k, v), d in zip(
                        batch.items(), (("batch", None), ("batch",)))})
                with torch.no_grad():
                    lg, cache = tmodel.decode_fn(params, cfg, batch, cache,
                                                 ctx)
                logits.append(_full(lg))
            runs.append((torch.stack(logits),
                         {k: _full(v) for k, v in cache.items()}))
        (la, ca), (lb, cb) = runs
        out[f"decode/{case}/logits"] = np.asarray(
            float((lb - la).abs().max() / la.abs().max()))
        worst = 0.0
        for k in ca:
            d = float((cb[k].float() - ca[k].float()).abs().max())
            worst = max(worst, d if ca[k].dtype == torch.int8
                        else d / float(ca[k].float().abs().max()))
        out[f"decode/{case}/cache"] = np.asarray(worst)


def serve(inp, out):
    """Each serve case: ``generate`` on a (2, 2) mesh and without one, from
    the dense step case's weights.  Records both runs' tokens, the prefill
    logits' largest difference over their max-abs, and the mesh run's
    calls of the two attention wrappers (each given local tensors, or it
    raises)."""
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.distributed.sharding import Recipe
    from repro_torch.kernels import ops
    from repro_torch.serve.engine import ServeEngine
    cfg = dataclasses.replace(reduced(ARCHS["starcoder2-3b"]),
                              dtype="float32")
    mesh = _mesh((2, 2), ("data", "model"))
    host = _unflatten(inp, "init/dense/")
    prompts = inp["serve/prompts"]
    calls = {"flash_attention": 0, "decode_attention": 0}
    real = {k: getattr(ops, k) for k in calls}

    def counted(name):
        def fn(*a, **kw):
            calls[name] += 1
            return real[name](*a, **kw)
        return fn

    for case, impl, kv in SERVE_CASES:
        recipe = Recipe(remat="none", attn_impl=impl, kv_cache_dtype=kv)
        res = {}
        for m in (None, mesh):
            for k in calls:
                calls[k] = 0
                setattr(ops, k, counted(k))
            try:
                eng = ServeEngine(cfg, host, mesh=m, recipe=recipe,
                                  max_seq=SERVE_MAX_SEQ, device="cpu")
                res[m is not None] = eng.generate(prompts, SERVE_NEW_TOKENS)
            finally:
                for k in calls:
                    setattr(ops, k, real[k])
        a, b = res[False], res[True]
        out[f"serve/{case}/tokens"] = a.tokens
        out[f"serve/{case}/mesh_tokens"] = b.tokens
        out[f"serve/{case}/logits"] = np.asarray(float(
            (b.prefill_logits - a.prefill_logits).abs().max()
            / a.prefill_logits.abs().max()))
        out[f"serve/{case}/calls"] = np.asarray(
            [calls["flash_attention"], calls["decode_attention"]])


def checkpoints(inp, out, root):
    """Mesh -> file (restored without a mesh by the test) and file (written
    without a mesh by the test) -> mesh."""
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.distributed import checkpoint as ck
    from repro_torch.distributed.elastic import reshard_params
    from repro_torch.distributed.sharding import Recipe
    from repro_torch.train.optimizer import leaves
    cfg = dataclasses.replace(reduced(ARCHS["starcoder2-3b"]),
                              dtype="float32")
    mesh = _mesh((2, 2), ("data", "model"))
    params = reshard_params(_unflatten(inp, "init/dense/"), cfg, mesh,
                            Recipe())
    ck.save_checkpoint(os.path.join(root, "from_mesh"), 7,
                       {"params": params})
    step, trees = ck.restore_checkpoint(os.path.join(root, "plain"))
    placed = reshard_params(trees["params"], cfg, mesh, Recipe())
    worst = 0.0
    for (_, a), (_, b) in zip(leaves(placed), leaves(trees["params"])):
        worst = max(worst, float((a.full_tensor() - b).abs().max()))
        assert a.to_local().numel() <= b.numel()
    out["ckpt/plain_to_mesh"] = np.asarray(worst)
    out["ckpt/plain_step"] = np.asarray(step)


def worker(rank, world, init, src, dst):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank,
                            world_size=world)
    try:
        inp = dict(np.load(src))
        out = {}
        placements(out)
        pod_mean(inp, out)
        mm_rule(out)
        checkpoints(inp, out, os.path.dirname(dst))
        decode(out)
        serve(inp, out)
        steps(inp, out)
        if rank == 0:
            np.savez(dst, **out)
    finally:
        dist.destroy_process_group()
