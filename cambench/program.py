"""What the program's own spans and counters read after a traced run.

``repro_torch.obs`` records while a ``torch.profiler`` records, so a
traced run's profiler window (the first ``TRACE_SECONDS`` or
``TRACE_STEPS`` of the window) turns it on, and nothing else does: its
numbers cover the same requests as the device trace.  A per-layer reader
divides what it reads by the calls of its cell's root span (``cam.tune``
a tune request, ``serving.ingest`` a batch).  A program without the
module, or without a call of the root span, reads nothing (None); a
counter that never fired reads 0.
"""
from __future__ import annotations


def per_root(root: str, total):
    """``total(snapshot)`` per call of span ``root``, or None."""
    try:
        from repro_torch import obs
    except ImportError:
        return None
    snap = obs.snapshot()
    calls = snap["spans"].get(root, {}).get("calls", 0)
    if not calls:
        return None
    return total(snap) / calls


def ms(snap, name: str, kind: str = "total_ms") -> float:
    """Milliseconds in span ``name`` (``kind``: ``total_ms`` or ``self_ms``)."""
    return float(snap["spans"].get(name, {}).get(kind, 0.0))


def counter(snap, name: str) -> float:
    return float(snap["counters"].get(name, 0))
