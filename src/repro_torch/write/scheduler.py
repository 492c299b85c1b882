"""Merge scheduling: WHEN to flush the delta, CAM-guided and baselines.

Every scheduler sees the same :class:`DecisionContext` — the per-event
price vector the session obtained from ONE ``PricingEngine.price`` call
(defer at the shrunken capacity, merged at the restored capacity, and the
merge burst itself) plus the delta state.  The CAM scheduler is the only
one that READS the prices; the baselines decide from counters, which is
precisely the comparison the benchmark runs.

The CAM rule is Eq. 15 with a time axis.  Eq. 15 picks the configuration
minimizing expected I/O per op at a fixed capacity; a merge decision is a
choice between two capacity TRAJECTORIES over the coming horizon:

    defer:  H * io(C_now)            (keep paying the shrunken cache)
    merge:  burst_io + H * io(C_0)   (pay the flush, then the full cache)

so merge wins when ``(io_defer - io_merged) * H > burst_io`` — deferral's
extra probe misses over the horizon outweigh the merge's own I/O.  H
counts expected READS (only probes pay the shrunken cache; staged writes
are free until merged).  Both sides of the inequality come out of the one
priced table; the decision itself is arithmetic on three floats (zero
model calls, structurally asserted in tests).

First-order is the RIGHT order here, not an approximation shortcut: under
continued write inflow both trajectories refill at the same rate, so the
capacity gap between them — d stolen pages — is invariant along the
horizon and the priced per-query gap holds to first order.  Curvature of
io(C) (convex: each stolen page hurts more than the last) makes deferral
slightly worse than charged, so the rule errs toward deferring, never
toward flushing early.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

__all__ = ["DecisionContext", "MergeDecision", "CamMergeScheduler",
           "EveryKScheduler", "OnFullScheduler"]


class DecisionContext(NamedTuple):
    """What the session hands a scheduler each decision event."""

    batch_index: int
    io_defer: float           # per-query I/O at C(d) — current delta fill
    io_merged: float          # per-query I/O at C(0) — delta flushed
    merge_io: float           # the merge burst's total physical I/O
    horizon_queries: float    # expected READS over the decision horizon
    delta_entries: int
    delta_full: bool
    batches_since_merge: int


class MergeDecision(NamedTuple):
    merge: bool
    reason: str
    benefit: float = 0.0      # (io_defer - io_merged) * horizon_queries
    cost: float = 0.0         # merge_io charged against the benefit


@dataclasses.dataclass
class CamMergeScheduler:
    """Merge when deferral's priced miss penalty beats the burst's I/O.

    ``safety`` scales the burst cost (>1 defers more, <1 flushes more);
    a full delta always flushes (memory is a hard bound).
    """

    safety: float = 1.0
    name: str = "cam"

    def decide(self, ctx: DecisionContext) -> MergeDecision:
        if ctx.delta_entries == 0:
            return MergeDecision(False, "empty")
        if ctx.delta_full:
            return MergeDecision(True, "full")
        benefit = max(ctx.io_defer - ctx.io_merged, 0.0) * ctx.horizon_queries
        cost = ctx.merge_io * self.safety
        if benefit > cost:
            return MergeDecision(True, "priced", benefit, cost)
        return MergeDecision(False, "priced", benefit, cost)


@dataclasses.dataclass
class EveryKScheduler:
    """Cache-oblivious baseline: merge every ``k`` ingested batches."""

    k: int = 8
    name: str = "every_k"

    def decide(self, ctx: DecisionContext) -> MergeDecision:
        if ctx.delta_entries == 0:
            return MergeDecision(False, "empty")
        if ctx.delta_full:
            return MergeDecision(True, "full")
        if ctx.batches_since_merge >= self.k:
            return MergeDecision(True, "period")
        return MergeDecision(False, "period")


@dataclasses.dataclass
class OnFullScheduler:
    """Cache-oblivious baseline: merge only when the delta is full."""

    name: str = "on_full"

    def decide(self, ctx: DecisionContext) -> MergeDecision:
        if ctx.delta_entries and ctx.delta_full:
            return MergeDecision(True, "full")
        return MergeDecision(False, "full")
