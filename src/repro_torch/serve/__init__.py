"""Serving plane: batched engine, paged KV pool, CAM-guided pool planner."""
from repro_torch.serve import engine, kv_cache, planner

__all__ = ["engine", "kv_cache", "planner"]
