"""Data substrate: synthetic SOSD-style datasets, workload mixtures and the
LM token pipeline."""
from repro_torch.data import datasets, pipeline, workloads

__all__ = ["datasets", "pipeline", "workloads"]
