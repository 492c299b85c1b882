"""JAX references of the multi-device parity tests, run as a script in a
process of its own with four host devices:

    XLA_FLAGS=--xla_force_host_platform_device_count=4 \
        python tests/_jax_mesh_ref.py IN.npz OUT.npz

``IN.npz`` (written by ``tests/test_torch_distributed.py``) holds the
initial weights of each step case under ``init/<case>/<leaf path>``, the
batches under ``batch/<case>/<step>/<key>``, and the compression inputs.
``OUT.npz`` gets, per placement case, each device's mesh coordinate and
index range; per step case, the losses, grad norms and final weights; and
the pod-gathered means and residuals of ``_pod_gather_mean`` under
``jax.vmap(..., axis_name="pod")``.
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

from _mesh_cases import OPT, PLACEMENTS, RECIPE, STEP_CASES, STEPS


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


def main(src, dst):
    inp = dict(np.load(src))
    out = {}
    placements(out)
    pod_mean(inp, out)
    steps(inp, out)
    np.savez(dst, **out)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
