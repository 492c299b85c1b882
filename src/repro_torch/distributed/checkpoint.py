"""Checkpointing: atomic, resumable, readable by the JAX package.

Mirrors ``repro/distributed/checkpoint.py``'s format: ``step_%08d/`` holds
one ``.npz`` per tree with ``/``-joined key paths and a ``meta.json`` with
the step and the tree names; writes go to a temp directory renamed into
place (atomic on POSIX), so a failure mid-save never corrupts the latest
checkpoint.  float32, int8 and int32 leaves are stored as they are, so
float32 and int8 training states move between the two packages both ways.

numpy has no bfloat16 without ``ml_dtypes``, so a bfloat16 leaf is stored
widened to float32 (exact) and its dtype recorded in ``meta.json`` under
``"dtypes"`` (tree name -> key path -> ``"bfloat16"``); restore narrows it
back, again exactly.  Restore returns trees of torch tensors on the
requested device.

Under a process group (a mesh), ``save_checkpoint`` takes DTensor leaves:
every rank joins their ``full_tensor()``, rank 0 alone writes, and a
barrier publishes the directory to all ranks; ``restore_checkpoint`` waits
on a barrier too, then each rank reads the whole arrays, which
``elastic.reshard_params`` (or the train step) places on any mesh.  The
format does not depend on the mesh, so a checkpoint written on one
restores without one and the reverse.
"""
from __future__ import annotations

import json
import os
import shutil
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.distributed.sharding import is_dtensor

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "flatten_tree", "unflatten_tree"]

_SEP = "/"
_WIDENED = {torch.bfloat16: "bfloat16"}


def flatten_tree(tree) -> Dict[str, Any]:
    flat = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}{_SEP}{k}" if prefix else str(k), v)
        else:
            flat[prefix] = node

    walk("", tree)
    return flat


def unflatten_tree(flat: Dict[str, Any]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for path, arr in flat.items():
        parts = path.split(_SEP)
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr
    return tree


def _world():
    """(rank, size) of the default process group, (0, 1) without one."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _barrier():
    import torch.distributed as dist
    if _world()[1] > 1:
        dist.barrier()


def _to_host(x) -> Tuple[np.ndarray, Optional[str]]:
    """(numpy array, recorded dtype name or None) of a leaf (a DTensor's
    whole array: a collective every rank joins)."""
    if not isinstance(x, torch.Tensor):
        return np.asarray(x), None
    if is_dtensor(x):
        x = x.full_tensor()
    x = x.detach().cpu()
    if x.dtype in _WIDENED:
        return x.to(torch.float32).numpy(), _WIDENED[x.dtype]
    return x.numpy(), None


def save_checkpoint(ckpt_dir: str, step: int, trees: Dict[str, Any],
                    extra_meta: Optional[dict] = None) -> str:
    """trees: e.g. {"params": ..., "opt_state": ...} (nested dicts of
    tensors, DTensors or arrays).  Under a process group every rank calls
    it; rank 0 writes."""
    writer = _world()[0] == 0
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if writer:
        os.makedirs(ckpt_dir, exist_ok=True)
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
    dtypes: Dict[str, Dict[str, str]] = {}
    for name, tree in trees.items():
        host = {}
        for path, x in flatten_tree(tree).items():
            host[path], dt = _to_host(x)
            if dt is not None:
                dtypes.setdefault(name, {})[path] = dt
        if writer:
            np.savez(os.path.join(tmp, f"{name}.npz"), **host)
    if not writer:
        _barrier()
        return final
    meta = {"step": int(step), "time": time.time(), "trees": sorted(trees),
            **(extra_meta or {})}
    if dtypes:
        meta["dtypes"] = dtypes
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)  # atomic publish
    _barrier()
    return final


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(".tmp")
             and os.path.exists(os.path.join(ckpt_dir, d, "meta.json"))]
    return max(steps) if steps else None


def restore_checkpoint(ckpt_dir: str, step: Optional[int] = None,
                       device="cpu") -> Tuple[int, Dict[str, Any]]:
    """(step, {tree name: tree of tensors on ``device``}) of ``step``, or
    of the latest checkpoint.  Under a process group every rank calls it
    and reads the whole arrays after a barrier."""
    _barrier()
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    dtypes = meta.get("dtypes", {})
    trees = {}
    for name in meta["trees"]:
        narrow = dtypes.get(name, {})
        with np.load(os.path.join(path, f"{name}.npz")) as z:
            flat = {}
            for k in z.files:
                t = torch.as_tensor(z[k], device=device)
                if k in narrow:
                    t = t.to(getattr(torch, narrow[k]))
                flat[k] = t
        trees[name] = unflatten_tree(flat)
    return int(meta["step"]), trees
