"""Simulated buffered-disk machine (stands in for the paper's NVMe server)."""
from repro_torch.sim import machine

__all__ = ["machine"]
