"""Legacy join-executor entry points (paper §VI-A, §VII-D).

The four strategies — INLJ, POINT-ONLY, RANGE-ONLY, HYBRID — are now
degenerate plans of :class:`repro_torch.join.session.JoinSession`; these
wrappers keep the original loose-argument signatures for callers that still
think in ``(layout, capacity, policy)`` tuples and route everything through
the one session execution path.  New code should construct a
``JoinSession`` with a :class:`repro_torch.core.session.System` directly.

Any index family (raw index or IndexModel adapter) is accepted: windows are
normalized by ``wrap_index`` / ``probe_windows``, so there is no per-design
tuple-shape special casing here anymore.

``torch_device`` says where the synthesized System prices: the card unless
the caller asks for the CPU (a CUDA request without a card raises).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core.cam import CamGeometry
from repro_torch.core.session import DEFAULT_TORCH_DEVICE, System
from repro_torch.index.adapters import wrap_index
from repro_torch.index.disk_layout import PageLayout
from repro_torch.join.hybrid import JoinCostParams
from repro_torch.join.session import JoinSession, JoinStats
from repro_torch.sim.machine import MachineParams

__all__ = ["JoinStats", "inlj", "point_only", "range_only", "hybrid_join",
           "session_for"]


def session_for(index, inner_keys: np.ndarray, layout: PageLayout,
                capacity: int, policy: str = "lru",
                machine: MachineParams = MachineParams(),
                params: Optional[JoinCostParams] = None,
                torch_device: str = DEFAULT_TORCH_DEVICE) -> JoinSession:
    """Bridge loose (layout, capacity, policy) arguments to a JoinSession.

    The synthesized System's memory budget is exactly ``capacity`` buffer
    pages once the index footprint is charged (the half-page slack absorbs
    float rounding in ``size_bytes``).
    """
    model = wrap_index(index)
    geom = CamGeometry(c_ipp=layout.c_ipp, page_bytes=layout.page_bytes)
    budget = (capacity + 0.5) * layout.page_bytes + float(model.size_bytes)
    system = System(geom=geom, memory_budget_bytes=budget, policy=policy,
                    torch_device=torch_device)
    return JoinSession(model, system, inner_keys=inner_keys, machine=machine,
                       params=params)


def inlj(index, inner_keys, outer_keys, layout: PageLayout, capacity: int,
         policy: str = "lru", machine: MachineParams = MachineParams(),
         torch_device: str = DEFAULT_TORCH_DEVICE) -> JoinStats:
    s = session_for(index, inner_keys, layout, capacity, policy, machine,
                    params=JoinCostParams(), torch_device=torch_device)
    return s.run(outer_keys, "inlj")


def point_only(index, inner_keys, outer_keys, layout: PageLayout,
               capacity: int, policy: str = "lru",
               machine: MachineParams = MachineParams(),
               torch_device: str = DEFAULT_TORCH_DEVICE) -> JoinStats:
    s = session_for(index, inner_keys, layout, capacity, policy, machine,
                    params=JoinCostParams(), torch_device=torch_device)
    return s.run(outer_keys, "point-only")


def range_only(index, inner_keys, outer_keys, layout: PageLayout,
               capacity: int, policy: str = "lru",
               machine: MachineParams = MachineParams(),
               torch_device: str = DEFAULT_TORCH_DEVICE) -> JoinStats:
    s = session_for(index, inner_keys, layout, capacity, policy, machine,
                    params=JoinCostParams(), torch_device=torch_device)
    return s.run(outer_keys, "range-only")


def hybrid_join(index, inner_keys, outer_keys, layout: PageLayout,
                capacity: int, policy: str = "lru",
                machine: MachineParams = MachineParams(),
                params: Optional[JoinCostParams] = None,
                n_min: int = 1024, k_max: int = 8192, gamma: float = 0.05,
                torch_device: str = DEFAULT_TORCH_DEVICE) -> JoinStats:
    s = session_for(index, inner_keys, layout, capacity, policy, machine,
                    params=params or JoinCostParams(),
                    torch_device=torch_device)
    return s.run(outer_keys, "hybrid", n_min=n_min, k_max=k_max, gamma=gamma)
