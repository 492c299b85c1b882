"""Gradient compression for the slow cross-pod axis.

Mirrors ``repro/distributed/compression.py``: int8 quantization with error
feedback.  Each pod quantizes its local gradient (plus the carried
quantization residual) with one scale per leaf, the int8 payloads and the
float32 scales are all-gathered over the "pod" dimension's process group
(4x fewer wire bytes than a float32 all-reduce), and every pod dequantizes
and averages locally, ``sum_p scale_p / n_pods * q_p`` in pod order.  The
residual ``ef`` makes the compression unbiased over time (error-feedback
SGD).

A leaf may be a DTensor on the pod's (data, model) sub-mesh: its scale is
then the max-abs of the whole leaf (a reduction over that sub-mesh, what
JAX's ``quantize_int8`` sees inside its ``shard_map``), and each rank sends
its local shard, which the ranks at the same (data, model) coordinate of
the other pods hold too.

Used by ``train_step`` when ``recipe.compress_pod_grads`` and the mesh has
a "pod" axis.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.distributed.sharding import is_dtensor
from repro_torch.train.optimizer import layer_slices, leaves

__all__ = ["compressed_pod_mean", "quantize_int8", "dequantize_int8"]


def _scale(absmax: torch.Tensor) -> torch.Tensor:
    return torch.clamp(absmax, min=1e-12) / 127.0


def _quantize_with(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    # torch.round, like jnp.round, rounds half to even
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = _scale(torch.max(torch.abs(x)))
    return _quantize_with(x, scale), scale.to(torch.float32)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def _local(x):
    return x.to_local() if is_dtensor(x) else x


def _gather(x: torch.Tensor, group) -> torch.Tensor:
    """(n_pods, ...) of ``x`` from every rank of the pod ``group``."""
    if group is None:
        return x[None]
    from torch.distributed import _functional_collectives as funcol
    return funcol.wait_tensor(funcol.all_gather_tensor(x[None], 0, group))


def _gather_mean(local: torch.Tensor, scale: torch.Tensor, n_pods: int,
                 group, s_all=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(pod mean, new residual) of one rank's ``local`` (a plain tensor,
    gradient plus residual) under the leaf's ``scale`` (a plain 0-d), and
    the pods' scales ``s_all`` (gathered here when None)."""
    q = _quantize_with(local, scale)
    new_ef = local - dequantize_int8(q, scale)
    q_all = _gather(q, group)                                 # int8 wire
    if s_all is None:
        s_all = _gather(scale, group)
    w = s_all / n_pods
    mean = w[0] * q_all[0].to(torch.float32)
    for p in range(1, n_pods):
        mean = mean + w[p] * q_all[p].to(torch.float32)
    return mean, new_ef


def _pod_gather_mean(leaf: torch.Tensor, ef: torch.Tensor, n_pods: int,
                     group=None):
    """Local quantize -> int8 all-gather over the pod ``group`` ->
    dequantized mean; returns (mean, new error residual), DTensors where
    ``leaf`` is one.  ``group`` None is a pod of one."""
    local = leaf + ef
    scale = torch.max(torch.abs(local))
    if is_dtensor(scale):
        scale = scale.full_tensor()
    mean, new_ef = _gather_mean(_local(local), _scale(scale).float(),
                                n_pods, group)
    if is_dtensor(leaf):
        from torch.distributed.tensor import DTensor
        mean, new_ef = (DTensor.from_local(t, leaf.device_mesh,
                                           leaf.placements, run_check=False)
                        for t in (mean, new_ef))
    return mean, new_ef


@torch.no_grad()
def compressed_pod_mean(grads: Any, ef: Any, mesh) -> Tuple[Any, Any]:
    """Average per-pod gradients across the mesh's "pod" axis with int8
    payloads, writing the means into ``grads`` (a float32 copy replaces a
    bfloat16 leaf) and the new residuals into ``ef`` in place (same trees,
    returned).

    A layer-stacked leaf is worked a layer slice at a time (its scale,
    the max-abs of the whole leaf, first), so no leaf-sized temporary
    exists beside the gradients and the residuals.
    """
    names = mesh.mesh_dim_names
    n_pods = mesh.size(names.index("pod"))
    group = mesh.get_group("pod")
    flat_e = [e for _, e in leaves(ef)]
    for (path, g), e in zip(leaves(grads), flat_e):
        if g.dtype != torch.float32:    # the means are float32, as JAX's
            node = grads
            for k in path[:-1]:
                node = node[k]
            node[path[-1]] = g = g.to(torch.float32)
        gs, es = layer_slices(path, g), layer_slices(path, e)
        absmax = torch.stack([(_local(gi) + _local(ei)).abs().max()
                              for gi, ei in zip(gs, es)]).max()
        if is_dtensor(g):           # the max over the pod's whole leaf
            from torch.distributed.tensor import DTensor, Partial
            absmax = DTensor.from_local(
                absmax, g.device_mesh, [Partial("max")] * g.device_mesh.ndim,
                run_check=False).full_tensor()
        scale = _scale(absmax).float()
        s_all = _gather(scale, group)       # once a leaf, not a slice
        for gi, ei in zip(gs, es):
            g_loc, e_loc = _local(gi), _local(ei)
            mean, new_ef = _gather_mean(g_loc + e_loc, scale, n_pods, group,
                                        s_all)
            e_loc.copy_(new_ef)
            g_loc.copy_(mean)
    return grads, ef
