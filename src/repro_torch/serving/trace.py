"""Trace frontend — the op-log schema and its compilation into Workloads.

A live system does not hand us a
:class:`~repro_torch.core.workload.Workload`; it hands us an append-only op
log.  This module owns the boundary: the
:class:`TraceEvent` record (point lookup, range scan, sorted-stream probe,
timestamp), JSONL parsing for persisted logs, in-memory batching iterators,
and :func:`compile_events`, which turns one batch of events into a Workload
through the SAME ``locate``/``from_keys`` path offline callers use — so a
trace-compiled batch prices identically to a hand-built workload.

Sorted probes deserve a note: a ``sorted`` event is ONE probe window of a
sorted-stream batch (a join leg, a bulk merge).  Consecutive sorted events
in a batch keep their order when compiled, which is exactly what the
Theorem III.1 closed forms need; interleaved point/range traffic compiles
into sibling parts of a mixed workload.

:func:`synthetic_drifting_trace` generates the piecewise-stationary streams
the drift benchmark and the smoke example replay: each segment fixes an op
mix, a hot region, and a range-width scale, so distribution shift happens
at known boundaries (giving the oracle-retune arm its oracle).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Iterable, Iterator, List, Optional, Sequence

import numpy as np

from repro_torch import obs
from repro_torch.core.workload import Workload, locate

__all__ = ["TraceEvent", "parse_jsonl", "to_jsonl", "iter_batches",
           "compile_events", "synthetic_drifting_trace"]

POINT = "point"
RANGE = "range"
SORTED = "sorted"
INSERT = "insert"
UPDATE = "update"
DELETE = "delete"

#: Mutating ops — key-shaped like ``point`` (one target key per event).
WRITE_OPS = (INSERT, UPDATE, DELETE)

_OPS = (POINT, RANGE, SORTED) + WRITE_OPS
_KEY_OPS = (POINT,) + WRITE_OPS


@dataclasses.dataclass(frozen=True)
class TraceEvent:
    """One op-log record.

    ``op`` is ``"point"`` (uses ``key``), ``"range"`` (``lo_key``/``hi_key``
    rank bounds after location), ``"sorted"`` (one probe window of a
    sorted stream, also ``lo_key``/``hi_key``), or a mutating op —
    ``"insert"`` / ``"update"`` / ``"delete"`` — which targets a single
    ``key`` exactly like ``point``.  ``ts`` is an arbitrary monotone
    timestamp — the serving loop batches by arrival order and only
    reports it.
    """

    op: str
    key: Optional[float] = None
    lo_key: Optional[float] = None
    hi_key: Optional[float] = None
    ts: float = 0.0

    def __post_init__(self):
        if self.op not in _OPS:
            raise ValueError(f"unknown trace op {self.op!r}; "
                             f"expected one of {_OPS}")
        if self.op in _KEY_OPS and self.key is None:
            raise ValueError(f"{self.op} event needs key")
        if self.op not in _KEY_OPS and (self.lo_key is None
                                        or self.hi_key is None):
            raise ValueError(f"{self.op} event needs lo_key and hi_key")


def to_jsonl(events: Iterable[TraceEvent]) -> str:
    """Serialize events to JSONL (one compact object per line)."""
    out = []
    for e in events:
        rec = {"op": e.op, "ts": e.ts}
        if e.op in _KEY_OPS:
            rec["key"] = e.key
        else:
            rec["lo_key"] = e.lo_key
            rec["hi_key"] = e.hi_key
        out.append(json.dumps(rec))
    return "\n".join(out) + ("\n" if out else "")


def parse_jsonl(source) -> Iterator[TraceEvent]:
    """Parse a JSONL op log into :class:`TraceEvent`s.

    ``source`` is a path, an open file, or any iterable of lines; blank
    lines are skipped.  Streaming — never materializes the trace.
    """
    if isinstance(source, (str, bytes)):
        with open(source) as f:
            yield from parse_jsonl(f)
        return
    for line in source:
        line = line.strip()
        if not line:
            continue
        rec = json.loads(line)
        yield TraceEvent(op=rec["op"], key=rec.get("key"),
                         lo_key=rec.get("lo_key"), hi_key=rec.get("hi_key"),
                         ts=float(rec.get("ts", 0.0)))


def iter_batches(events: Iterable[TraceEvent],
                 batch_size: int) -> Iterator[List[TraceEvent]]:
    """Chop an event stream into arrival-order batches (last may be short)."""
    if batch_size < 1:
        raise ValueError("batch_size must be >= 1")
    batch: List[TraceEvent] = []
    for e in events:
        batch.append(e)
        if len(batch) >= batch_size:
            yield batch
            batch = []
    if batch:
        yield batch


@obs.traced("serving.compile")
def compile_events(events: Sequence[TraceEvent],
                   keys: np.ndarray) -> Workload:
    """Compile one event batch into a Workload against ``keys``.

    Point events locate through the same ``searchsorted`` path as
    ``Workload.from_keys`` (query keys are kept so routing indexes — RMI —
    can profile the batch); range and sorted events locate both bounds,
    and a range part keeps both endpoints' keys for the same reason.
    Mutating events (insert/update/delete) locate their target key the same
    way and compile into the matching write parts.  Within every compiled
    part the events keep their arrival order (the per-op grouping is a
    stable filter over the batch — regression-tested), and sorted probes in
    particular keep the order the closed forms need.  A single-op batch
    compiles to that part directly; otherwise the parts compose into a
    mixed workload, which ``Workload.mixed``'s flattening lets downstream
    code concatenate freely.
    """
    if not events:
        raise ValueError("cannot compile an empty event batch")
    keys = np.asarray(keys)
    n = int(keys.shape[0])
    point_keys = [e.key for e in events if e.op == POINT]
    range_bounds = [(e.lo_key, e.hi_key) for e in events if e.op == RANGE]
    sorted_bounds = [(e.lo_key, e.hi_key) for e in events if e.op == SORTED]

    parts = []
    if point_keys:
        qk = np.asarray(point_keys)
        parts.append(Workload.point(locate(keys, qk), n=n, query_keys=qk))
    if range_bounds:
        lo, hi = np.asarray(range_bounds).T
        lo_pos = locate(keys, lo)
        hi_pos = np.maximum(locate(keys, hi), lo_pos)
        parts.append(Workload.range_scan(lo_pos, hi_pos, n=n, query_keys=lo,
                                         hi_query_keys=hi))
    if sorted_bounds:
        lo, hi = np.asarray(sorted_bounds).T
        lo_pos = locate(keys, lo)
        hi_pos = np.maximum(locate(keys, hi), lo_pos)
        parts.append(Workload.sorted_stream(lo_pos, hi_pos, n=n))
    for op, build in ((INSERT, Workload.insert), (UPDATE, Workload.update),
                      (DELETE, Workload.delete)):
        wkeys = [e.key for e in events if e.op == op]
        if wkeys:
            qk = np.asarray(wkeys)
            parts.append(build(locate(keys, qk), n=n, query_keys=qk))
    return parts[0] if len(parts) == 1 else Workload.mixed(*parts)


# ---------------------------------------------------------------------------
# Synthetic piecewise-drifting traces
# ---------------------------------------------------------------------------

DEFAULT_SEGMENT = {
    "events": 2048,          # events in this stationary segment
    # (point, range, sorted[, insert, update, delete]) op probabilities —
    # 3-tuples stay valid (write mass 0), 6-tuples add mutating traffic
    "mix": (1.0, 0.0, 0.0),
    "hot_center": 0.5,       # hot-region center, fraction of the key space
    "hot_width": 0.1,        # hot-region width, fraction of the key space
    "hot_frac": 0.9,         # probability a query lands in the hot region
    "range_width": 64,       # mean range/sorted window width, in ranks
    "sorted_run": 32,        # consecutive probes per sorted sweep
}


def synthetic_drifting_trace(keys: np.ndarray, segments: Sequence[dict],
                             seed: int = 0) -> List[TraceEvent]:
    """Piecewise-stationary op log over ``keys``.

    Each segment dict overrides :data:`DEFAULT_SEGMENT`.  Inside a segment
    the distribution is fixed: ops are drawn from ``mix``, query positions
    from a hot/cold mixture (``hot_frac`` mass uniform on the
    ``hot_center`` ± ``hot_width``/2 slab, the rest uniform everywhere),
    range widths geometric with mean ``range_width``, and sorted ops emit
    ``sorted_run`` consecutive stride-advancing windows (a miniature merge
    sweep).  Drift is whatever differs between consecutive segments.
    """
    keys = np.asarray(keys)
    n = int(keys.shape[0])
    rng = np.random.default_rng(seed)
    events: List[TraceEvent] = []
    ts = 0.0

    def draw_pos(seg) -> int:
        if rng.random() < seg["hot_frac"]:
            lo = max(0.0, seg["hot_center"] - seg["hot_width"] / 2)
            hi = min(1.0, seg["hot_center"] + seg["hot_width"] / 2)
            return int(rng.uniform(lo, hi) * (n - 1))
        return int(rng.integers(0, n))

    def width(seg) -> int:
        return int(1 + rng.geometric(1.0 / max(seg["range_width"], 1)))

    for spec in segments:
        seg = {**DEFAULT_SEGMENT, **spec}
        mix = tuple(seg["mix"]) + (0.0,) * (6 - len(seg["mix"]))
        p_point, p_range, p_sorted = mix[:3]
        write_ps = mix[3:]
        total = sum(mix)
        emitted = 0
        while emitted < seg["events"]:
            ts += 1.0
            u = rng.random() * total
            if u >= p_point + p_range + p_sorted:
                # mutating op: target key drawn from the same hot/cold mix
                u -= p_point + p_range + p_sorted
                op = WRITE_OPS[0 if u < write_ps[0] else
                               1 if u < write_ps[0] + write_ps[1] else 2]
                pos = draw_pos(seg)
                events.append(TraceEvent(op, key=float(keys[pos]), ts=ts))
                emitted += 1
            elif u < p_point:
                pos = draw_pos(seg)
                events.append(TraceEvent(POINT, key=float(keys[pos]), ts=ts))
                emitted += 1
            elif u < p_point + p_range:
                lo = draw_pos(seg)
                hi = min(n - 1, lo + width(seg))
                events.append(TraceEvent(
                    RANGE, lo_key=float(keys[lo]), hi_key=float(keys[hi]),
                    ts=ts))
                emitted += 1
            else:
                # one sorted sweep: windows advance monotonically
                lo = draw_pos(seg)
                run = min(seg["sorted_run"], seg["events"] - emitted)
                w = width(seg)
                for _ in range(run):
                    hi = min(n - 1, lo + w)
                    events.append(TraceEvent(
                        SORTED, lo_key=float(keys[lo]),
                        hi_key=float(keys[hi]), ts=ts))
                    lo = min(n - 1, hi + 1)
                    emitted += 1
    return events
