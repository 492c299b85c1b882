"""Data substrate: synthetic SOSD-style datasets and workload mixtures."""
from repro_torch.data import datasets, workloads

__all__ = ["datasets", "workloads"]
