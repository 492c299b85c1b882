"""Sharded CAM: fleet-wide I/O pricing and the joint shard search.

``ShardedSystem`` describes N nodes over one key-space partition;
``ShardingSession`` solves the joint (shard-boundary × per-shard knob ×
fleet-budget-split) search with one profile pass and one solve pass, and
``rebalance`` prices hot-shard boundary moves against the rebuild gate.
"""
from .route import RouteStats, boundary_candidates, quantile_boundaries, route
from .session import (FleetPlan, RebalanceResult, ShardPlan,
                      ShardingSession)
from .system import Shard, ShardedSystem, even_boundaries

__all__ = [
    "Shard",
    "ShardedSystem",
    "even_boundaries",
    "route",
    "RouteStats",
    "quantile_boundaries",
    "boundary_candidates",
    "ShardingSession",
    "ShardPlan",
    "FleetPlan",
    "RebalanceResult",
]
