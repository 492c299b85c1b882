"""Logical-axis sharding: recipes, param definitions, and the sharding context.

Mirrors ``repro/distributed/sharding.py``.  A ``Recipe`` maps logical
dimension roles to mesh axes (MaxText-style rules table).  Dims are only
sharded when evenly divisible by the axis-group size, with automatic
fallback to the largest feasible prefix of the axis group, then to
replication.

The mesh is a ``torch.distributed.device_mesh.DeviceMesh`` whose
``mesh_dim_names`` are the JAX axis names.  ``spec`` returns JAX's
``PartitionSpec`` as a tuple (one entry per tensor dim: ``None``, an axis
name, or a tuple of names) and ``sharding`` its DTensor counterpart: the
mesh and one placement per mesh dim, ``Shard(d)`` where the spec names that
mesh axis on tensor dim ``d``, else ``Replicate()``.  A tensor dim named by
several mesh axes is split by them major to minor in mesh order, as JAX
splits it in the order of its tuple, so every rank holds the index range
JAX gives the device at the same mesh coordinate.  ``constrain``
redistributes a DTensor to those placements (which also resolves
``Partial``).  With no mesh every method is the single-device no-op.

Roles:
  weights:     "fsdp" (d_model/storage dim), "tp" (heads*head_dim / d_ff /
               vocab), "ep" (experts), None (replicated: norms, small vectors)
  activations: "batch", "seq" (sequence parallelism), "heads", "kv_seq"
               (decode-cache length), None
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

__all__ = ["Recipe", "ParamDef", "ShardingCtx", "NamedSharding",
           "axis_group_size", "axis_sizes", "tree_specs", "tree_shardings",
           "place", "is_dtensor", "from_shard"]


@dataclasses.dataclass(frozen=True)
class Recipe:
    """Distribution recipe — the same fields and defaults as the JAX one."""

    batch_axes: Tuple[str, ...] = ("data",)
    fsdp_axes: Tuple[str, ...] = ("data",)
    tp_axes: Tuple[str, ...] = ("model",)
    ep_axes: Tuple[str, ...] = ("model",)
    seq_axes: Tuple[str, ...] = ()
    act_embed_axes: Tuple[str, ...] = ()
    kv_batch_axes: Optional[Tuple[str, ...]] = None
    kv_seq_axes: Tuple[str, ...] = ("model",)
    remat: str = "block"                      # none | block | nested
    microbatch: int = 1
    grad_dtype: str = "float32"
    kv_cache_dtype: str = "bfloat16"          # bfloat16 | int8 (decode cache)
    param_dtype: str = "float32"
    unroll_microbatches: bool = False
    attn_impl: str = "blockwise"              # blockwise | dense | pallas
    block_kv: int = 1024
    compress_pod_grads: bool = False
    moment_dtype: Optional[str] = None
    scan_layers: bool = True

    def role_axes(self, role: Optional[str]) -> Tuple[str, ...]:
        return {
            None: (),
            "fsdp": self.fsdp_axes,
            "tp": self.tp_axes,
            "ep": self.ep_axes,
            "batch": self.batch_axes,
            "seq": self.seq_axes,
            "heads": self.tp_axes,
            "act_embed": self.act_embed_axes,
            "kv_batch": (self.kv_batch_axes if self.kv_batch_axes is not None
                         else self.batch_axes),
            "kv_seq": self.kv_seq_axes,
        }[role]


@dataclasses.dataclass(frozen=True)
class ParamDef:
    """Shape + logical roles + initializer for one parameter tensor."""

    shape: Tuple[int, ...]
    dims: Tuple[Optional[str], ...]     # role per dim ("fsdp"/"tp"/"ep"/None)
    init: str = "normal"                # normal | zeros | ones
    scale: float = -1.0                 # -1 -> 1/sqrt(fan_in) heuristic

    def fan_in(self) -> int:
        return self.shape[-2] if len(self.shape) >= 2 else self.shape[-1]


class NamedSharding(NamedTuple):
    """The counterpart of ``jax.sharding.NamedSharding``: a mesh, the JAX
    spec and the DTensor placements (one per mesh dim) it gives."""

    mesh: Any
    spec: Tuple
    placements: Tuple


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh``."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def axis_group_size(mesh, axes: Tuple[str, ...]) -> int:
    sizes = axis_sizes(mesh)
    return int(math.prod(sizes[a] for a in axes)) if axes else 1


_DTENSOR = []


def is_dtensor(x) -> bool:
    if not _DTENSOR:
        from torch.distributed.tensor import DTensor
        _DTENSOR.append(DTensor)
    return isinstance(x, _DTENSOR[0])


def from_shard(local: torch.Tensor, mesh, placements, shape):
    """The DTensor of which ``local`` is this rank's shard: a tensor of
    global ``shape``, laid out in the order of ``local``'s dims, split by
    ``placements``.  Naming the shape keeps an uneven split (3 rows on 2
    ranks) one tensor on every rank; ``DTensor.from_local`` alone takes
    each rank's shard as an even one."""
    from torch.distributed.tensor import DTensor
    shape = tuple(shape)
    stride = [0] * len(shape)
    acc = 1
    for i in sorted(range(len(shape)), key=local.stride):   # innermost first
        stride[i] = acc
        acc *= shape[i]
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=shape, stride=tuple(stride))


def place(x: torch.Tensor, sharding: Optional[NamedSharding]):
    """A DTensor of ``x`` (the whole tensor, the same on every rank) with
    ``sharding``'s placements: each rank keeps its own slice, so placing
    moves no data between ranks.  ``x`` itself without a sharding."""
    if sharding is None:
        return x
    from torch.distributed.tensor import DTensor, Replicate
    mesh = sharding.mesh
    full = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)
    return full.redistribute(mesh, sharding.placements)


class _Constrain(torch.autograd.Function):
    """``redistribute`` whose gradient is redistributed to the same
    placements, as JAX transposes ``with_sharding_constraint`` into the
    same constraint on the cotangent.  (DTensor's own backward would hand
    the gradient on in whatever layout the ops after the constraint left
    it, a partial sum or a sequence split the next reshape cannot keep.)"""

    @staticmethod
    def forward(ctx, x, placements):
        ctx.placements = placements
        return x.redistribute(x.device_mesh, placements)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(g.device_mesh, ctx.placements), None


class ShardingCtx:
    """Threads (mesh, recipe) through model code; no-ops when mesh is None."""

    def __init__(self, mesh=None, recipe: Recipe = Recipe()):
        self.mesh = mesh
        self.recipe = recipe

    # -- spec construction -------------------------------------------------
    def _resolve(self, size: int, role: Optional[str]):
        if self.mesh is None or role is None:
            return None
        axes = self.recipe.role_axes(role)
        while axes:
            group = axis_group_size(self.mesh, axes)
            if group > 1 and size % group == 0:
                return axes if len(axes) > 1 else axes[0]
            axes = axes[:-1]  # drop trailing axis, retry with smaller group
        return None

    def spec(self, shape: Tuple[int, ...],
             dims: Tuple[Optional[str], ...]) -> Tuple:
        """JAX's ``PartitionSpec`` of ``shape`` under ``dims``, as a tuple."""
        if len(shape) != len(dims):
            raise ValueError(f"shape {tuple(shape)} and dims {dims} differ "
                             "in rank")
        entries = [self._resolve(s, d) for s, d in zip(shape, dims)]
        # one mesh axis may appear at most once in a spec: drop duplicates
        used = set()
        clean = []
        for e in entries:
            names = e if isinstance(e, tuple) else (e,) if e else ()
            if any(n in used for n in names):
                clean.append(None)
            else:
                used.update(names)
                clean.append(e)
        return tuple(clean)

    def placements(self, spec: Tuple) -> Tuple:
        """One DTensor placement per mesh dim for ``spec``."""
        from torch.distributed.tensor import Replicate, Shard
        names = self.mesh.mesh_dim_names
        out = [Replicate()] * len(names)
        for d, e in enumerate(spec):
            group = e if isinstance(e, tuple) else (e,) if e else ()
            order = [names.index(n) for n in group]
            if order != sorted(order):
                raise ValueError(
                    f"spec entry {e} splits a dim against the mesh's axis "
                    f"order {names}; DTensor splits major to minor in mesh "
                    "order")
            for i in order:
                out[i] = Shard(d)
        return tuple(out)

    def sharding(self, shape, dims) -> Optional[NamedSharding]:
        if self.mesh is None:
            return None
        spec = self.spec(tuple(shape), tuple(dims))
        return NamedSharding(self.mesh, spec, self.placements(spec))

    # -- activation constraints --------------------------------------------
    def constrain(self, x, *dims):
        """``x`` redistributed to the placements ``dims`` give; ``x``
        unchanged without a mesh.  A plain tensor is taken as the same
        whole tensor on every rank."""
        if self.mesh is None:
            return x
        sh = self.sharding(x.shape, dims)
        if not is_dtensor(x):
            return place(x, sh)
        return _Constrain.apply(x, sh.placements)

    def scope(self):
        """The context model code runs in: under a mesh, tensors it makes
        itself (RoPE tables, zero states, masks, position ids) meet
        DTensors as replicated ones."""
        if self.mesh is None:
            return contextlib.nullcontext()
        from torch.distributed.tensor import DTensor
        from torch.distributed.tensor.experimental import implicit_replication
        if DTensor._op_dispatcher._allow_implicit_replication:
            # already on: implicit_replication() would turn it off on exit
            return contextlib.nullcontext()
        return implicit_replication()


def _map_defs(fn, defs):
    if isinstance(defs, ParamDef):
        return fn(defs)
    return {k: _map_defs(fn, v) for k, v in defs.items()}


def tree_specs(ctx: ShardingCtx, defs: Dict[str, Any]):
    """Map a (nested) dict of ParamDef to specs."""
    return _map_defs(lambda d: ctx.spec(d.shape, d.dims), defs)


def tree_shardings(ctx: ShardingCtx, defs):
    return _map_defs(lambda d: ctx.sharding(d.shape, d.dims), defs)
