"""WriteSession — the write-path serving loop (trace in, I/O ledger out).

Drives the full pipeline over a live read/write op log: batches compile
through the shared trace frontend, reads feed the sliding-window sketch
(incremental profiles, no replay), writes stage into the
:class:`~repro_torch.write.delta.DeltaBuffer`, and at every batch boundary the
session prices the merge question through the engine and lets the
configured scheduler decide.

The pricing discipline is the headline invariant: each decision event
builds ONE three-cell :class:`~repro_torch.engine.table.PriceTable` — the
live read mix at the shrunken capacity ``C(d)``, the same mix at the restored
capacity ``C(0)``, and the merge burst row — and makes ONE
``PricingEngine.price`` call.  Every scheduler (CAM and both baselines)
consumes the same priced context, every arm pays the same accounting, and
``engine.calls`` counts exactly one increment per decision event
(structurally asserted in tests/test_torch_write_path.py).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.session import (CostSession, GridCandidate,
                                      GridProfiles, System)
from repro_torch.core.workload import MIXED, WRITE_KINDS, Workload
from repro_torch.engine.table import PriceTable, PricingEngine
from repro_torch.serving.sketch import WindowSketch
from repro_torch.serving.trace import TraceEvent, compile_events, iter_batches
from repro_torch.write.delta import DeltaBuffer, merge_burst_workload
from repro_torch.write.scheduler import DecisionContext, MergeDecision

__all__ = ["WriteConfig", "WriteSession", "WriteSessionReport",
           "BatchRecord", "split_reads_writes"]


def split_reads_writes(workload: Workload
                       ) -> Tuple[Optional[Workload], Optional[Workload]]:
    """Split a compiled batch into its read and write halves (either may be
    None).  Non-mixed workloads route whole; mixed parts regroup."""
    parts = workload.parts if workload.kind == MIXED else (workload,)
    reads = [p for p in parts if p.kind not in WRITE_KINDS]
    writes = [p for p in parts if p.kind in WRITE_KINDS]

    def regroup(ps):
        if not ps:
            return None
        return ps[0] if len(ps) == 1 else Workload.mixed(*ps)

    return regroup(reads), regroup(writes)


@dataclasses.dataclass(frozen=True)
class WriteConfig:
    """Knobs of the write-path loop (delta sizing, horizon, batching)."""

    batch_size: int = 256
    window_chunks: int = 8
    delta_capacity_entries: int = 8192
    delta_entry_bytes: float = 16.0
    horizon_batches: float = 4.0
    #: Each merged page is read and written back; 2.0 charges both streams.
    merge_write_factor: float = 2.0
    profile_executor: Optional[str] = None
    price_executor: Optional[str] = None


@dataclasses.dataclass
class BatchRecord:
    """One decision event's ledger row."""

    batch_index: int
    n_reads: int
    n_writes: int
    delta_entries: int
    cap_now: int
    cap_empty: int
    io_defer: float
    io_merged: float
    merge_io: float
    read_io: float
    merged: bool
    reason: str


@dataclasses.dataclass
class WriteSessionReport:
    """End-of-trace accounting for one scheduler arm."""

    scheduler: str
    records: List[BatchRecord]
    read_io: float            # Σ batch reads * per-query I/O at C(d)
    merge_io: float           # Σ merge bursts' physical I/O
    merges: int
    engine_calls: int
    decision_events: int

    @property
    def total_io(self) -> float:
        return self.read_io + self.merge_io

    def summary(self) -> dict:
        return {"scheduler": self.scheduler, "total_io": self.total_io,
                "read_io": self.read_io, "merge_io": self.merge_io,
                "merges": self.merges, "engine_calls": self.engine_calls,
                "decision_events": self.decision_events}


def _stack_profiles(a: GridProfiles, b: GridProfiles) -> GridProfiles:
    """Concatenate profile rows over the SAME page space (read mix row(s) +
    merge burst row) so one table prices them in one launch."""
    wa = a.wparts if a.wparts else (None,) * len(a.knobs)
    wb = b.wparts if b.wparts else (None,) * len(b.knobs)
    wparts = tuple(wa) + tuple(wb)
    return GridProfiles(
        knobs=a.knobs + b.knobs,
        counts=torch.cat([a.counts, b.counts], dim=0),
        totals=np.concatenate([a.totals, b.totals]),
        dacs=np.concatenate([a.dacs, b.dacs]),
        sizes=np.concatenate([a.sizes, b.sizes]),
        caps=np.concatenate([a.caps, b.caps]),
        sparts=tuple(a.sparts) + tuple(b.sparts),
        skipped=tuple(a.skipped) + tuple(b.skipped),
        scale=a.scale,
        n_queries=a.n_queries + b.n_queries,
        wparts=(wparts if any(w is not None for w in wparts) else ()))


class WriteSession:
    """Serve a read/write trace against one live index configuration.

    ``candidate`` is the live structure being served — a uniform-eps
    ``GridCandidate`` or an index-backed one (ALEX/B+-tree adapters), same
    protocol the tuning grid uses.  The scheduler is a strategy object from
    ``repro_torch.write.scheduler``; swapping it is the benchmark's only
    difference between arms.
    """

    def __init__(self, keys: np.ndarray, system: System, scheduler, *,
                 candidate: GridCandidate,
                 config: WriteConfig = WriteConfig()):
        self.keys = np.asarray(keys)
        self.n = int(self.keys.shape[0])
        self.system = system
        self.scheduler = scheduler
        self.config = config
        self.cost = CostSession(system)
        self.engine = PricingEngine(self.cost,
                                    executor=config.price_executor)
        self.candidate = candidate
        self.sketch = WindowSketch(self.cost, [candidate],
                                   window_chunks=config.window_chunks,
                                   profile_executor=config.profile_executor)
        self.delta = DeltaBuffer(
            capacity_entries=config.delta_capacity_entries,
            entry_bytes=config.delta_entry_bytes)
        self.cap_empty = int(system.capacity_for(candidate.size_bytes))
        self.batches_since_merge = 0

    # ------------------------------------------------------------------ parts
    def _capacity_now(self) -> int:
        stolen = self.delta.stolen_pages(self.system.geom.page_bytes)
        return max(self.cap_empty - stolen, 0)

    def _burst_profiles(self) -> Tuple[GridProfiles, int]:
        burst = merge_burst_workload(self.delta.positions(), self.n,
                                     self.system.geom.c_ipp)
        profs = self.cost.grid_profiles(
            [GridCandidate(knob="merge_burst", eps=0,
                           size_bytes=self.candidate.size_bytes)],
            burst, executor=self.config.profile_executor)
        return profs, burst.n_queries

    def _price_event(self) -> Tuple[float, float, float]:
        """ONE engine call: (io_defer, io_merged, merge_io_total)."""
        read_profs = self.sketch.to_profiles()
        cells = [("defer", 0, np.asarray([self._capacity_now()])),
                 ("merged", 0, np.asarray([self.cap_empty]))]
        if self.delta.entries:
            burst_profs, n_windows = self._burst_profiles()
            profs = _stack_profiles(read_profs, burst_profs)
            cells.append(("burst", len(read_profs.knobs),
                          np.asarray([self.cap_empty])))
        else:
            profs, n_windows = read_profs, 0
        sol = self.engine.price(PriceTable.from_cells(profs, cells))
        io_defer, io_merged = float(sol.io[0]), float(sol.io[1])
        merge_io = (float(sol.io[2]) * n_windows
                    * self.config.merge_write_factor
                    if self.delta.entries else float("inf"))
        return io_defer, io_merged, merge_io

    # -------------------------------------------------------------------- run
    def run(self, events: Sequence[TraceEvent]) -> WriteSessionReport:
        records: List[BatchRecord] = []
        read_io_total = 0.0
        merge_io_total = 0.0
        for i, batch in enumerate(iter_batches(events,
                                               self.config.batch_size)):
            wl = compile_events(batch, self.keys)
            reads, writes = split_reads_writes(wl)
            n_reads = reads.n_queries if reads is not None else 0
            n_writes = writes.n_queries if writes is not None else 0
            if reads is not None:
                self.sketch.update(reads)
            if writes is not None:
                self.delta.stage(writes)
            if len(self.sketch) == 0:
                # nothing priceable yet (pure-write prefix): stage and wait
                records.append(BatchRecord(i, n_reads, n_writes,
                                           self.delta.entries,
                                           self._capacity_now(),
                                           self.cap_empty, 0.0, 0.0,
                                           float("inf"), 0.0, False,
                                           "no_reads_yet"))
                continue

            io_defer, io_merged, merge_io = self._price_event()
            batch_read_io = io_defer * n_reads
            read_io_total += batch_read_io
            # ledger the state the DECISION saw (pre-flush)
            cap_now, delta_entries = self._capacity_now(), self.delta.entries

            # only reads pay io_defer, so the horizon counts expected reads;
            # the CURRENT batch's read rate predicts the coming regime far
            # better than a lifetime mean on piecewise-stationary traffic
            # (the lagging mean stalls big post-burst flushes for batches)
            horizon = self.config.horizon_batches * n_reads
            decision: MergeDecision = self.scheduler.decide(DecisionContext(
                batch_index=i, io_defer=io_defer, io_merged=io_merged,
                merge_io=merge_io, horizon_queries=horizon,
                delta_entries=self.delta.entries,
                delta_full=self.delta.full,
                batches_since_merge=self.batches_since_merge))
            merged = bool(decision.merge and self.delta.entries)
            if merged:
                merge_io_total += merge_io
                self.delta.clear()
                self.batches_since_merge = 0
            else:
                self.batches_since_merge += 1
            records.append(BatchRecord(
                i, n_reads, n_writes, delta_entries,
                cap_now, self.cap_empty, io_defer, io_merged,
                merge_io if merge_io != float("inf") else 0.0,
                batch_read_io, merged, decision.reason))
        return WriteSessionReport(
            scheduler=getattr(self.scheduler, "name",
                              type(self.scheduler).__name__),
            records=records, read_io=read_io_total,
            merge_io=merge_io_total, merges=self.delta.merges,
            engine_calls=self.engine.calls,
            decision_events=sum(1 for r in records
                                if r.reason != "no_reads_yet"))
