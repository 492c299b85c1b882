"""Production mesh construction and the roofline constants.

Mirrors ``repro/launch/mesh.py``.  Defined as functions, so importing this
module touches no process group.  The production mesh is an H100 cluster:
32 nodes x 8 GPUs as ``("data", "model") = (32, 8)``, so the tensor-parallel
"model" axis stays inside a node's NVLink domain and "data" runs across
nodes.  Multi-pod: 2 such pods, ``("pod", "data", "model") = (2, 32, 8)``.
The mesh is built over the ranks of the current default process group; a
world of another size is refused.  ``shape`` overrides the production shape
(the axis names stay those of a single- or multi-pod mesh).

``H100`` takes the card's data sheet (SXM5): 989e12 dense bf16 FLOP/s,
3.35e12 B/s of HBM3, NVLink 4 at 450e9 B/s a direction as ``ici_bw``, one
400 Gb/s NDR InfiniBand port (50e9 B/s) as ``dcn_bw``, and 85,017,493,504
bytes of memory, what ``torch.cuda.get_device_properties(0).total_memory``
reports on an H100 80GB HBM3 (torch 2.11, CUDA 12.8).  ``V5E`` is the JAX package's TPU constant,
kept so the port's roofline reproduces the reference's table.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

__all__ = ["make_production_mesh", "production_shape", "HardwareSpec",
           "V5E", "H100"]


def production_shape(multi_pod: bool = False) -> Tuple[Tuple[int, ...],
                                                       Tuple[str, ...]]:
    """(shape, axis names) of the production mesh."""
    if multi_pod:
        return (2, 32, 8), ("pod", "data", "model")
    return (32, 8), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False,
                         shape: Optional[Tuple[int, ...]] = None,
                         device_type: str = "cuda"):
    """A ``DeviceMesh`` over the default process group's ranks."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    want, names = production_shape(multi_pod)
    shape = tuple(shape) if shape is not None else want
    if len(shape) != len(names):
        raise ValueError(f"mesh shape {shape} does not name {names}")
    if not dist.is_initialized():
        raise RuntimeError("make_production_mesh needs an initialised "
                           "process group")
    world = dist.get_world_size()
    if world != math.prod(shape):
        raise ValueError(f"a {'x'.join(map(str, shape))} mesh needs "
                         f"{math.prod(shape)} ranks; the process group has "
                         f"{world}")
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


class HardwareSpec:
    """Roofline constants for the target chip."""

    def __init__(self, name: str, peak_flops: float, hbm_bw: float,
                 ici_bw: float, hbm_bytes: float, dcn_bw: float = 25e9):
        self.name = name
        self.peak_flops = peak_flops      # bf16 FLOP/s per chip
        self.hbm_bw = hbm_bw              # bytes/s per chip
        self.ici_bw = ici_bw              # bytes/s per intra-pod link
        self.hbm_bytes = hbm_bytes        # memory capacity per chip
        self.dcn_bw = dcn_bw              # bytes/s per chip across pods


V5E = HardwareSpec("tpu-v5e", peak_flops=197e12, hbm_bw=819e9,
                   ici_bw=50e9, hbm_bytes=16 * 2**30)

H100 = HardwareSpec("h100-sxm5-80gb", peak_flops=989e12, hbm_bw=3.35e12,
                    ici_bw=450e9, hbm_bytes=85_017_493_504, dcn_bw=50e9)
