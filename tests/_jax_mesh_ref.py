"""JAX references of the multi-device parity tests, run as a script in a
process of its own with four host devices:

    XLA_FLAGS=--xla_force_host_platform_device_count=4 \
        python tests/_jax_mesh_ref.py IN.npz OUT.npz
        python tests/_jax_mesh_ref.py --argument-bytes OUT.json

``IN.npz`` (written by ``tests/test_torch_distributed.py``) holds the
initial weights of each step case under ``init/<case>/<leaf path>``, the
batches under ``batch/<case>/<step>/<key>``, and the compression inputs.
``OUT.npz`` gets, per placement case, each device's mesh coordinate and
index range; per step case, the losses, grad norms and final weights; and
the pod-gathered means and residuals of ``_pod_gather_mean`` under
``jax.vmap(..., axis_name="pod")``; and per serve case with a bfloat16
cache (the only cache JAX's engine allocates), the tokens of
``ServeEngine(mesh=...).generate`` on (data 2, model 2).  With
``--argument-bytes`` it writes instead, per dry-run cell of
``_mesh_cases.DRYRUN_CELLS`` (a reduced config on (data 2, model 2),
``launch.cells.build_cell`` compiled), the compiled step's
``memory_analysis().argument_size_in_bytes``.
"""
import dataclasses
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import AxisType, NamedSharding
from jax.sharding import PartitionSpec as P

from repro.configs import ARCHS, reduced
from repro.distributed import compression
from repro.distributed.sharding import Recipe, ShardingCtx, tree_shardings
from repro.models import params as params_mod
from repro.train import optimizer as opt_mod
from repro.train import train_step as ts_mod

from _mesh_cases import (DRYRUN_CELLS, OPT, PLACEMENTS, RECIPE, SERVE_CASES,
                         SERVE_MAX_SEQ, SERVE_NEW_TOKENS, STEP_CASES, STEPS)


def config(arch):
    return dataclasses.replace(reduced(ARCHS[arch]), dtype="float32")


def mesh_of(shape, names):
    return jax.make_mesh(shape, names, axis_types=(AxisType.Auto,) * len(names))


def unflatten(flat, prefix):
    tree = {}
    for k, v in flat.items():
        if not k.startswith(prefix):
            continue
        parts = k[len(prefix):].split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def flatten(tree, prefix, out):
    for k, v in tree.items():
        if isinstance(v, dict):
            flatten(v, f"{prefix}{k}/", out)
        else:
            out[prefix + k] = np.asarray(v)


def placements(out):
    for i, (shape, names, gshape, spec) in enumerate(PLACEMENTS):
        mesh = mesh_of(shape, names)
        x = jax.device_put(np.zeros(gshape, np.float32),
                           NamedSharding(mesh, P(*spec)))
        rows = []
        for sh in x.addressable_shards:
            coord = np.argwhere(mesh.devices == sh.device)[0]
            rng = [(s.start or 0, s.stop if s.stop is not None else n)
                   for s, n in zip(sh.index, gshape)]
            rows.append([list(map(int, coord)), rng])
        out[f"placement/{i}"] = np.asarray(json.dumps(sorted(rows)))


def steps(inp, out):
    for case, arch, shape, names, kw in STEP_CASES:
        cfg = config(arch)
        recipe = Recipe(**RECIPE, **kw)
        opt = opt_mod.AdamWConfig(**OPT)
        mesh = mesh_of(shape, names)
        tree = unflatten(inp, f"init/{case}/")
        with jax.set_mesh(mesh):
            ctx = ShardingCtx(mesh, recipe)
            params = jax.tree.map(
                lambda a, s: jax.device_put(jnp.asarray(a), s), tree,
                tree_shardings(ctx, params_mod.param_defs(cfg)))
            opt_state = ts_mod.init_opt_state(params, cfg, recipe, opt)
            step = jax.jit(ts_mod.make_train_step(cfg, recipe, mesh, opt))
            losses, norms = [], []
            for i in range(STEPS):
                batch = {k: jnp.asarray(v) for k, v in
                         unflatten(inp, f"batch/{case}/{i}/").items()}
                params, opt_state, m = step(params, opt_state, batch)
                losses.append(float(m["loss"]))
                norms.append(float(m["grad_norm"]))
        out[f"loss/{case}"] = np.asarray(losses)
        out[f"grad_norm/{case}"] = np.asarray(norms)
        flatten(jax.device_get(params), f"final/{case}/", out)


def pod_mean(inp, out):
    leaf, ef = jnp.asarray(inp["pod/leaf"]), jnp.asarray(inp["pod/ef"])
    n = leaf.shape[0]
    mean, new_ef = jax.vmap(
        lambda g, e: compression._pod_gather_mean(g, e, n),
        axis_name="pod")(leaf, ef)
    out["pod/mean"] = np.asarray(mean)
    out["pod/new_ef"] = np.asarray(new_ef)


def serve(inp, out):
    from repro.serve.engine import ServeEngine
    cfg = config("starcoder2-3b")
    mesh = mesh_of((2, 2), ("data", "model"))
    params = jax.tree.map(jnp.asarray, unflatten(inp, "init/dense/"))
    for case, impl, kv in SERVE_CASES:
        if kv != "bfloat16":
            continue
        with jax.set_mesh(mesh):
            eng = ServeEngine(cfg, params, mesh=mesh,
                              recipe=Recipe(remat="none", attn_impl=impl),
                              max_seq=SERVE_MAX_SEQ)
            res = eng.generate(inp["serve/prompts"], SERVE_NEW_TOKENS)
        out[f"serve/{case}/mesh_tokens"] = np.asarray(res.tokens)


def argument_bytes(dst):
    from repro.configs.base import ShapeSpec
    from repro.launch.cells import build_cell, default_recipe
    mesh = mesh_of((2, 2), ("data", "model"))
    out = {}
    for arch, kind, seq, batch in DRYRUN_CELLS:
        cfg = reduced(ARCHS[arch])
        shape = ShapeSpec(f"{kind}_small", kind, seq, batch)
        with jax.set_mesh(mesh):
            fn, args = build_cell(cfg, shape, mesh,
                                  default_recipe(cfg, shape))
            ma = fn.lower(*args).compile().memory_analysis()
        out[f"{arch}/{kind}"] = int(ma.argument_size_in_bytes)
    with open(dst, "w") as f:
        json.dump(out, f)


def main(src, dst):
    inp = dict(np.load(src))
    out = {}
    placements(out)
    pod_mean(inp, out)
    serve(inp, out)
    steps(inp, out)
    np.savez(dst, **out)


if __name__ == "__main__":
    if sys.argv[1] == "--argument-bytes":
        argument_bytes(sys.argv[2])
    else:
        main(sys.argv[1], sys.argv[2])
