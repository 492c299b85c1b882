"""Piecewise-stationary op logs (the drift script of the serving benchmark).

Frozen copy of ``repro_torch.serving.trace.synthetic_drifting_trace`` and
``DEFAULT_SEGMENT`` at commit 841dd630a0202e497cba3d6a4c1d3efa933a6491,
for read ops (point, range, sorted).  It draws the same random numbers in
the same order and returns each event's true positions, ``(op, lo, hi,
ts)`` with ``hi == lo`` for a point; the driver turns them into the
program's ``TraceEvent``s by the keys at those positions.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

DEFAULT_SEGMENT = {
    "events": 2048,
    "mix": (1.0, 0.0, 0.0),      # (point, range, sorted) probabilities
    "hot_center": 0.5,
    "hot_width": 0.1,
    "hot_frac": 0.9,
    "range_width": 64,
    "sorted_run": 32,
}

Event = Tuple[str, int, int, float]


def drifting_trace(n: int, segments: Sequence[dict],
                   rng: np.random.Generator) -> List[Event]:
    events: List[Event] = []
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
        mix = tuple(seg["mix"])
        if len(mix) != 3:
            raise ValueError("the frozen drift script has read ops only")
        p_point, p_range, p_sorted = mix
        total = sum(mix)
        emitted = 0
        while emitted < seg["events"]:
            ts += 1.0
            u = rng.random() * total
            if u < p_point:
                pos = draw_pos(seg)
                events.append(("point", pos, pos, ts))
                emitted += 1
            elif u < p_point + p_range:
                lo = draw_pos(seg)
                hi = min(n - 1, lo + width(seg))
                events.append(("range", lo, hi, ts))
                emitted += 1
            else:
                lo = draw_pos(seg)
                run = min(seg["sorted_run"], seg["events"] - emitted)
                w = width(seg)
                for _ in range(run):
                    hi = min(n - 1, lo + w)
                    events.append(("sorted", lo, hi, ts))
                    lo = min(n - 1, hi + 1)
                    emitted += 1
    return events
