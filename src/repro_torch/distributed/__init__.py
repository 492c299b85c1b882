"""Distribution recipes and the single-device sharding context.

Meshes (DeviceMesh/DTensor) wait for the distributed slice; this package
holds what the models need on one card.
"""
from repro_torch.distributed import sharding

__all__ = ["sharding"]
