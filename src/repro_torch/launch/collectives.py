"""Collective accounting for the roofline: the counterpart of
``repro/launch/hlo.py``.

Torch has no compiled HLO text to parse, so the collectives are read where
a step issues them: :class:`CollectiveLog` is a ``TorchDispatchMode`` that
lets DTensor desugar each op first (it declines DTensor ops, as
``CommDebugMode`` does) and then records every ``_c10d_functional`` (and
``c10d``) collective with its output bytes, in program order.
``collective_schedule`` and ``collective_bytes`` keep hlo.py's names and
return shapes: ``[(kind, output_bytes)]``, and the bytes per kind
(``all-gather``, ``all-reduce``, ``reduce-scatter``, ``all-to-all``,
``collective-permute``) plus ``total``.  Unlike the HLO text of a scanned
module, the log holds every collective the step ran, each layer's and
each microbatch's included.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["CollectiveLog", "collective_bytes", "collective_schedule"]

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "send": "collective-permute",
    "recv_": "collective-permute",
}


def _nbytes(out) -> int:
    if isinstance(out, torch.Tensor):
        return out.numel() * out.element_size()
    if isinstance(out, (list, tuple)):
        return sum(_nbytes(o) for o in out)
    return 0


class CollectiveLog(TorchDispatchMode):
    """Records ``(kind, output_bytes)`` of every collective run inside it
    (``schedule``)."""

    def __init__(self):
        super().__init__()
        self.schedule: List[Tuple[str, int]] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented     # DTensor desugars it into local ops
        out = func(*args, **kwargs)
        if func.namespace in ("_c10d_functional", "c10d_functional", "c10d"):
            kind = _KINDS.get(func._opname)
            if kind is not None:
                res = out[0] if func.namespace == "c10d" else out
                self.schedule.append((kind, _nbytes(res)))
        return out


def collective_schedule(log: CollectiveLog) -> List[Tuple[str, int]]:
    """[(op_kind, output_bytes)] for every collective in program order."""
    return list(log.schedule)


def collective_bytes(log: CollectiveLog) -> Dict[str, int]:
    """Total output bytes per collective kind (+ 'total')."""
    totals: Dict[str, int] = {k: 0 for k in _COLLECTIVES}
    for kind, nbytes in collective_schedule(log):
        totals[kind] += nbytes
    totals["total"] = sum(totals[k] for k in _COLLECTIVES)
    return totals
