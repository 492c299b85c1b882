"""Dry run of a cell on the H100 production mesh, without hardware.

Mirrors ``repro/launch/dryrun.py``: the same flags and the same JSONL
record.  Where JAX lowers and compiles the step for 256 (or 512) host
placeholder devices, this runs one step of the cell for rank 0 of a fake
process group of that many ranks (``torch.testing``'s ``fake`` backend:
collectives return at once), under ``FakeTensorMode``: every tensor has
its shape and dtype and no storage.  Rank 0's program stands for every
rank, since the step is SPMD.

Per cell it records: ``status``; the ``recipe``; ``memory`` per rank:
``argument_bytes`` (params, optimizer state, batch, cache: each rank's
shards), ``output_bytes`` and ``alias_bytes`` (outputs that are arguments
updated in place), ``peak_bytes`` (the live-storage high-water mark of the
step, arguments included), ``temp_bytes`` (peak less arguments),
``resident_plus_temp`` and ``fits_80g`` against ``H100.hbm_bytes``; and
``collectives`` (``launch.collectives``: kinds, count, bytes per kind).

The peak is the eager program's: storages counted from the op that makes
them to the moment the last reference (a view, a tensor saved for the
backward) dies, in the order the step runs.  XLA's peak is that of its
compiled schedule, which may reorder, fuse away intermediates and reuse
buffers; neither counts the CUDA caching allocator's slack.

Importing this module sets up no process group and no environment
variable; ``run_cell`` and ``main`` do.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-34b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--out f.jsonl]
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
import traceback
import weakref
from typing import Optional, Tuple, Union

import torch

from repro_torch.configs import ARCHS, SHAPES
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch import collectives as coll_mod
from repro_torch.launch.cells import (build_cell, cell_skip_reason,
                                      default_recipe, optimized_overrides)
from repro_torch.launch.mesh import (H100, make_production_mesh,
                                     production_shape)

__all__ = ["run_cell", "main"]


class _StepLog(coll_mod.CollectiveLog):
    """Collectives, and the bytes of live storages with their peak."""

    def __init__(self):
        super().__init__()
        self.live = 0
        self.peak = 0
        self.paused = 0
        self._seen = {}

    def _free(self, key):
        self.live -= self._seen.pop(key)

    def track(self, t):
        if self.paused or not isinstance(t, torch.Tensor) \
                or t.device.type == "meta":
            return
        st = t.untyped_storage()
        key = id(st)
        if key in self._seen:
            return
        self._seen[key] = st.nbytes()
        self.live += self._seen[key]
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if out is not NotImplemented:
            for t in (out if isinstance(out, (list, tuple)) else (out,)):
                self.track(t)
        return out


@contextlib.contextmanager
def _untracked_propagation(log: _StepLog):
    """DTensor's sharding propagation runs each new op once on whole-shape
    fake tensors (in a fake mode of its own) to learn its output's shape;
    those are scratch of the tracer, not of the step, so ``log`` ignores
    them.  The step's own ``FakeTensorMode`` is lifted meanwhile: some
    placement rules read small index tensors they build themselves."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    saved = {}
    for name in ("propagate", "propagate_op_sharding_non_cached"):
        fn = getattr(ShardingPropagator, name, None)
        if fn is None:
            continue
        saved[name] = fn

        def paused(self, *a, _fn=fn, **kw):
            log.paused += 1
            try:
                with unset_fake_temporarily():
                    return _fn(self, *a, **kw)
            finally:
                log.paused -= 1

        setattr(ShardingPropagator, name, paused)
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(ShardingPropagator, name, fn)


def _locals(tree):
    """The local tensors of a tree (DTensor shards, plain tensors)."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _locals(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _locals(v)
    elif isinstance(tree, torch.Tensor):
        yield tree.to_local() if hasattr(tree, "to_local") else tree


def _storage_bytes(tensors) -> Tuple[int, set]:
    seen = {}
    for t in tensors:
        st = t.untyped_storage()
        seen[id(st)] = st.nbytes()
    return sum(seen.values()), set(seen)


def _fake_world(n: int):
    """A fake process group of ``n`` ranks (this process is rank 0)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == n and \
                dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def _mesh_label(shape) -> str:
    return "x".join(str(s) for s in shape)


def run_cell(arch: str, shape_name: Union[str, ShapeSpec],
             multi_pod: bool = False,
             recipe_overrides=None, verbose: bool = True,
             optimized: bool = False,
             mesh_shape: Optional[Tuple[int, ...]] = None) -> dict:
    """Trace one step of a cell for rank 0 of the fake production mesh
    (``mesh_shape`` overrides its shape, the axis names kept;
    ``shape_name`` may be a ``ShapeSpec`` of its own)."""
    cfg = ARCHS[arch]
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    if optimized:
        recipe_overrides = {**optimized_overrides(cfg, shape),
                            **(recipe_overrides or {})}
    dims, names = production_shape(multi_pod)
    dims = tuple(mesh_shape) if mesh_shape is not None else dims
    rec = {"arch": arch, "shape": shape.name, "optimized": optimized,
           "mesh": _mesh_label(dims)}
    skip = cell_skip_reason(cfg, shape)
    if skip:
        rec.update(status="skipped", reason=skip)
        return rec
    t0 = time.perf_counter()
    try:
        from torch._subclasses.fake_tensor import FakeTensorMode

        _fake_world(math.prod(dims))
        mesh = make_production_mesh(multi_pod=multi_pod, shape=dims,
                                    device_type="cpu")
        recipe = default_recipe(cfg, shape, multi_pod,
                                mesh_shape=dict(zip(names, dims)),
                                **(recipe_overrides or {}))
        fn, make_args = build_cell(cfg, shape, mesh, recipe, device="cpu")
        log = _StepLog()
        with FakeTensorMode(), _untracked_propagation(log), log:
            args = make_args(fake=True)
            arg_bytes, arg_keys = _storage_bytes(list(_locals(args)))
            out = fn(*args)
            out_bytes, out_keys = _storage_bytes(list(_locals(out)))
            alias = sum(st.nbytes() for t in _locals(out)
                        for st in [t.untyped_storage()]
                        if id(st) in arg_keys & out_keys)
            peak = log.peak
        sched = coll_mod.collective_schedule(log)
        coll = coll_mod.collective_bytes(log)
        resident = arg_bytes + out_bytes - alias
        rec.update(
            status="ok",
            compile_seconds=round(time.perf_counter() - t0, 2),
            recipe={"microbatch": recipe.microbatch, "remat": recipe.remat,
                    "batch_axes": recipe.batch_axes,
                    "fsdp_axes": recipe.fsdp_axes,
                    "compress_pod_grads": recipe.compress_pod_grads},
            memory={
                "argument_bytes": arg_bytes,
                "output_bytes": out_bytes,
                "temp_bytes": max(peak - arg_bytes, 0),
                "peak_bytes": peak,
                "alias_bytes": alias,
                "resident_plus_temp": max(peak, resident),
                "fits_80g": bool(max(peak, resident) <= H100.hbm_bytes),
            },
            collectives={"kinds": sorted({k for k, _ in sched}),
                         "n_ops": len(sched), **coll},
        )
    except Exception as e:  # noqa: BLE001 — sweep must survive cell failures
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   trace=traceback.format_exc()[-2000:],
                   compile_seconds=round(time.perf_counter() - t0, 2))
    if verbose:
        mem = rec.get("memory", {})
        print(f"[{rec['mesh']}] {arch} x {shape.name}: {rec['status']}"
              + (f" peak={mem.get('peak_bytes', 0)/2**30:.2f}GiB"
                 f" resident+temp={mem.get('resident_plus_temp', 0)/2**30:.2f}GiB"
                 f" fits80G={mem.get('fits_80g')}"
                 f" t={rec.get('compile_seconds')}s"
                 if rec["status"] == "ok"
                 else f" {rec.get('reason') or rec.get('error')}"),
              flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), default=None)
    ap.add_argument("--shape", choices=sorted(SHAPES), default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="results/dryrun.jsonl")
    ap.add_argument("--optimized", action="store_true",
                    help="apply the hillclimbed per-cell recipe overrides")
    ap.add_argument("--resume", action="store_true",
                    help="skip cells already present in --out")
    args = ap.parse_args(argv)

    cells = []
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    if args.all:
        for mp in meshes:
            for arch in ARCHS:
                for shape in SHAPES:
                    cells.append((arch, shape, mp))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape (or --all)")
        for mp in meshes:
            cells.append((args.arch, args.shape, mp))

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    done = set()
    if args.resume and os.path.exists(args.out):
        with open(args.out) as f:
            for line in f:
                r = json.loads(line)
                if r.get("status") in ("ok", "skipped"):
                    done.add((r["arch"], r["shape"], r["mesh"]))
    with open(args.out, "a") as f:
        for arch, shape, mp in cells:
            key = (arch, shape, _mesh_label(production_shape(mp)[0]))
            if key in done:
                continue
            rec = run_cell(arch, shape, mp, optimized=args.optimized)
            f.write(json.dumps(rec) + "\n")
            f.flush()


if __name__ == "__main__":
    main()
