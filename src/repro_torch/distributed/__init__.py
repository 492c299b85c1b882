"""Distributed runtime: sharding recipes and the mesh context (DTensor),
checkpointing, fault tolerance, elastic re-meshing, gradient compression."""
from repro_torch.distributed import sharding

__all__ = ["sharding"]
