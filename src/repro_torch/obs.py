"""Spans and transfer counters of the CAM path.

The program records where its host time goes at its layer boundaries:

* ``span(name)`` (a context manager) and ``traced(name)`` (a decorator)
  time a block or a call with ``time.perf_counter_ns``;
* ``count(name, n)`` adds ``n`` to a counter, and to the innermost open
  span's share of it;
* ``to_host(tensor)`` and ``to_device(array, device)`` move data between
  the host and the card.  Both directions block the host until the card
  has finished the work queued before them: a read from the card waits for
  the work it depends on, and an upload from host memory is a blocking
  copy that synchronizes the stream.  A read is timed as span ``cam.d2h``
  and counted in ``sync.count`` and ``d2h.bytes``, an upload as span
  ``cam.h2d`` and counted in ``sync.count`` and ``h2d.bytes``; the counts
  are charged to the span that asked for the transfer.

The recorder is on while ``enable()`` holds or a ``torch.profiler`` is
recording.  Off, a span costs a flag test and the profiler test and
returns a shared no-op object, and a counter costs the same tests.  While
a profiler records, a span also opens a profiler record-function scope,
so it lies on the profiler's timeline beside the CUDA kernels, on the
same clock.  It is the function-scope kind: a user-scope
``torch.profiler.record_function`` is mirrored on the device timeline as a
range that spans every kernel launched inside it, which a reader of the
trace's device events would take for device work.  Spans never
synchronize the device: where the host waits for the card, the wait is the
host time of the blocking transfer.

A span opened while no span is open on its thread starts a request: it
takes a new request id, and every span opened inside it shares that id.
Finished spans go to a bounded in-memory buffer (``records()``); past its
size they only count as ``dropped``, and ``snapshot()``'s aggregates stay
whole.

The CAM path's spans (parents before their children):

=========================  ==============================================
``cam.locate``             ``core.workload.locate`` (``searchsorted``)
``cam.tune``               ``TuningSession.tune``, a tune request's root
``cam.profile``            ``CostSession.grid_profiles``
``cam.route``              RMI routing: every candidate's leaf bounds of
                           the point keys and both range endpoints
``cam.profile.upload``     positions copied to the card
``cam.profile.histogram``  the histogram pass (banded matmul, difference
                           arrays, sorted-stream statistics,
                           ``profile_grid``)
``cam.profile.range``      the range rows of a routing grid, each end at
                           its own leaf's bound
``cam.table``              ``PriceTable.from_profiles`` and
                           ``cross_policies``
``cam.price``              ``PricingEngine.price``
``cam.price.marshal``      the device executor's layout and per-row
                           statistics
``cam.price.launch``       the uploads and the ``price_grid`` call
``serving.compile``        ``serving.trace.compile_events``
``serving.ingest``         ``ServingSession.ingest``, a batch's root
``serving.sketch``         ``WindowSketch.update``
``serving.sketch.chunk``   ``WindowSketch._chunk_from``
``serving.drift``          the window summary and its TV distance
``serving.retune``         ``ServingSession._retune``
``serving.merge``          ``WindowSketch.to_profiles``
``cam.d2h``                every blocking read from the card
``cam.h2d``                every blocking upload from host memory
=========================  ==============================================

Counters: ``locate.mapped_queries`` (queries ``locate`` answers in the
key file's own dtype, where their dtype differs from it),
``locate.cast_bytes`` (the bytes ``searchsorted`` allocates to convert the
key file, and the queries, to their common dtype where ``locate`` cannot
map the queries), ``route.keys`` (keys an RMI routed to a leaf, point
keys and range endpoints, summed over the candidates), ``sync.count``
(transfers that block on the card, both directions), ``d2h.bytes`` and
``h2d.bytes``.
"""
from __future__ import annotations

import functools
import itertools
import threading
import time
from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

__all__ = ["SpanRecord", "active", "count", "disable", "enable",
           "records", "reset", "snapshot", "span", "to_device", "to_host",
           "traced"]

#: Finished spans ``records()`` keeps; later ones only count as dropped.
MAX_RECORDS = 1 << 16

_profiling = torch._C._autograd._profiler_enabled
_ProfilerScope = torch._C._profiler._RecordFunctionFast


class SpanRecord(NamedTuple):
    """One finished span."""

    id: int
    name: str
    start_ns: int                 # time.perf_counter_ns()
    end_ns: int
    parent: Optional[int]         # id of the enclosing span
    request: int


class _Recorder:
    """Aggregates and records of spans and counters, for one process."""

    def __init__(self):
        self.enabled = False
        self.max_records = MAX_RECORDS
        self._lock = threading.Lock()
        self._local = threading.local()
        self.reset()

    def reset(self) -> None:
        """Forget every aggregate, counter and record (open spans stay)."""
        with self._lock:
            self._spans: Dict[str, List[int]] = {}   # calls, total, self ns
            self._counters: Dict[str, int] = defaultdict(int)
            self._by_span: Dict[str, Dict[str, int]] = defaultdict(
                lambda: defaultdict(int))
            self._records: List[SpanRecord] = []
            self.dropped = 0
            self._ids = itertools.count()
            self._requests = itertools.count()

    def stack(self) -> list:
        """The open spans of the calling thread, innermost last."""
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def add(self, name: str, n) -> None:
        stack = self.stack()
        with self._lock:
            self._counters[name] += n
            if stack:
                self._by_span[stack[-1].name][name] += n

    def finish(self, sp: "_Span", end: int) -> None:
        dur = end - sp.start
        if sp.parent is not None:
            sp.parent.child_ns += dur
        with self._lock:
            agg = self._spans.get(sp.name)
            if agg is None:
                agg = self._spans[sp.name] = [0, 0, 0]
            agg[0] += 1
            agg[1] += dur
            agg[2] += dur - sp.child_ns
            if len(self._records) < self.max_records:
                self._records.append(SpanRecord(
                    sp.id, sp.name, sp.start, end,
                    None if sp.parent is None else sp.parent.id, sp.request))
            else:
                self.dropped += 1

    def snapshot(self) -> dict:
        """Per span name: calls, total and self ms (self: the duration less
        the part its child spans cover); every counter in total and by the
        span it was charged to; the records kept and dropped."""
        with self._lock:
            return {
                "spans": {name: {"calls": c, "total_ms": t * 1e-6,
                                 "self_ms": s * 1e-6}
                          for name, (c, t, s) in self._spans.items()},
                "counters": dict(self._counters),
                "counters_by_span": {name: dict(c)
                                     for name, c in self._by_span.items()},
                "records": len(self._records),
                "dropped": self.dropped,
            }

    def records(self) -> List[SpanRecord]:
        with self._lock:
            return list(self._records)


class _Span:
    __slots__ = ("rec", "name", "id", "parent", "request", "start",
                 "child_ns", "scope")

    def __init__(self, rec: _Recorder, name: str):
        self.rec = rec
        self.name = name

    def __enter__(self):
        stack = self.rec.stack()
        parent = stack[-1] if stack else None
        self.parent = parent
        self.request = (parent.request if parent is not None
                        else next(self.rec._requests))
        self.id = next(self.rec._ids)
        self.child_ns = 0
        self.scope = None
        if _profiling():
            self.scope = _ProfilerScope(self.name)
            self.scope.__enter__()
        stack.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        if self.scope is not None:
            self.scope.__exit__(None, None, None)
        self.rec.stack().pop()
        self.rec.finish(self, end)
        return False


class _Off:
    """The span of a recorder that is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()
_RECORDER = _Recorder()


def active() -> bool:
    """Whether spans and counters record now."""
    return _RECORDER.enabled or _profiling()


def span(name: str):
    """A context manager timing its block as span ``name``."""
    if _RECORDER.enabled or _profiling():
        return _Span(_RECORDER, name)
    return _OFF


def traced(name: str):
    """Decorator: every call of the function is a span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not (_RECORDER.enabled or _profiling()):
                return fn(*args, **kwargs)
            with _Span(_RECORDER, name):
                return fn(*args, **kwargs)
        return call
    return wrap


def count(name: str, n=1) -> None:
    """Add ``n`` to counter ``name`` and to the innermost open span's share."""
    if _RECORDER.enabled or _profiling():
        _RECORDER.add(name, n)


def to_host(x) -> np.ndarray:
    """``x`` as a host numpy array (a tensor already on the host is shared,
    as ``Tensor.numpy`` shares it).

    Reading a tensor that lives on a device blocks until the device has
    written it; while the recorder is on, the read is span ``cam.d2h`` and
    adds to ``sync.count`` and ``d2h.bytes``.
    """
    if not isinstance(x, torch.Tensor):
        return np.asarray(x)
    x = x.detach()
    if x.device.type == "cpu" or not active():
        return x.cpu().numpy()
    with span("cam.d2h"):
        out = x.cpu().numpy()
    count("sync.count")
    count("d2h.bytes", out.nbytes)
    return out


def to_device(x, device, dtype=None) -> torch.Tensor:
    """``torch.as_tensor(x, dtype=dtype, device=device)``.

    Copying host memory (an array, a scalar, a CPU tensor) to a CUDA device
    is a blocking copy: the stream is synchronized first, so the host waits
    for the work queued before it.  While the recorder is on, such a copy is
    span ``cam.h2d`` and adds to ``sync.count`` and ``h2d.bytes``.  A tensor
    already on a device copies nothing from the host.
    """
    if (not active() or torch.device(device).type != "cuda"
            or (isinstance(x, torch.Tensor) and x.device.type != "cpu")):
        return torch.as_tensor(x, dtype=dtype, device=device)
    with span("cam.h2d"):
        out = torch.as_tensor(x, dtype=dtype, device=device)
    count("sync.count")
    count("h2d.bytes", out.numel() * out.element_size())
    return out


def enable() -> None:
    """Record from now on, with or without a profiler."""
    _RECORDER.enabled = True


def disable() -> None:
    """Record only while a profiler records."""
    _RECORDER.enabled = False


def reset() -> None:
    """Forget every aggregate, counter and record."""
    _RECORDER.reset()


def snapshot() -> dict:
    """See :meth:`_Recorder.snapshot`."""
    return _RECORDER.snapshot()


def records() -> List[SpanRecord]:
    """The finished spans kept, in the order they ended."""
    return _RECORDER.records()
