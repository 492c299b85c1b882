"""HostExecutor — the golden-reference PriceTable executor.

One delegation: ``CostSession.solve_profiles`` (one batched
``hit_rate_grid`` dispatch over the gathered rows).  This IS the
pre-engine code path, so results are bit-identical to the legacy
per-session table assembly — the equivalence suite pins the fused
DeviceExecutor against it.
"""
from __future__ import annotations

import numpy as np

__all__ = ["HostExecutor"]


class HostExecutor:
    """Solve a PriceTable through the session's batched host pipeline."""

    name = "host"

    def solve(self, engine, table, row_scale):
        # Looked up on the session instance so monkeypatched counters
        # (class- or instance-level) keep observing the one solve call.
        # Multi-policy tables hand the per-cell policy column through;
        # solve_profiles groups by policy internally (one hit_rate_grid
        # dispatch per distinct policy), still ONE solve_profiles call.
        h, n_distinct = engine.cost.solve_profiles(
            table.profiles, table.caps, rows=table.rows,
            policies=table.pols)
        # No device-side argmin: the engine ranks on the host.
        return (np.asarray(h, np.float64),
                np.asarray(n_distinct, np.float64), None)
