"""ServingSession — the drift → retune → (maybe) rebuild loop.

Consumes a live op stream, maintains a :class:`WindowSketch` over it, and
keeps one deployed (knob, buffer-split) configuration honest against the
workload the system is ACTUALLY seeing.  Three rules, in order:

1. **Detect** — after each ingested batch, compare the live window summary
   against the summary the current configuration was tuned on
   (:func:`~repro_torch.serving.sketch.tv_distance`).  Hysteresis keeps the
   detector quiet around the threshold: after any retune evaluation the
   trigger disarms, re-arming only once divergence falls back below
   ``threshold - hysteresis`` (or keeps worsening by another hysteresis
   step — sustained deepening drift must not be maskable by one refused
   evaluation), and a cooldown bounds evaluation frequency outright.

2. **Retune** — on a trigger, re-run the joint (knob x buffer-split)
   search on the live sketch via ``TuningSession.tune_from_profiles``.
   This is the load-bearing structural property of the serving loop: the
   sketch IS the workload — no trace replay, no ``grid_profiles`` pass,
   just one batched ``solve_profiles`` over the (knob x split) table
   (asserted in ``tests/test_torch_serving.py``).

3. **Decide** — the rebuild-cost-aware extension of Eq. 15/16.  The paper
   trades index footprint against buffer pages at a fixed instant; serving
   adds the time axis: switching configurations costs real I/O — a key-file
   scan to rebuild (``num_pages(n)`` reads), writing the new index
   (``ceil(size/page)`` writes), and re-warming the buffer priced through
   the same cache model (the new steady state holds ``min(capacity, N)``
   pages, each a cold miss).  Switch only when

       (io_cur - io_new) * horizon_queries  >  rebuild_io,

   i.e. when predicted steady-state savings over the configured horizon
   repay the modeled rebuild.  ``io_cur`` is the CURRENT configuration
   priced on the LIVE sketch — read off the same solved table, zero extra
   model calls.  Disabling the gate (``rebuild_gate=False``) yields the
   retune-every-drift-event baseline the drift benchmark compares against.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch import obs
from repro_torch.core.workload import Workload
from repro_torch.serving.sketch import (DEFAULT_PAGE_BINS, WindowSketch,
                                        tv_distance)
from repro_torch.serving.trace import TraceEvent, compile_events, iter_batches
from repro_torch.tuning.session import (IndexBuilder, TuneResult,
                                        TuningSession, _feasibility_split)

__all__ = ["ServingConfig", "ServingStats", "RetuneDecision", "BatchReport",
           "ServingSession"]


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """Knobs of the serving loop itself (not of the index)."""

    batch_size: int = 512          # events per ingested batch
    window_chunks: int = 8         # sliding-window length, in batches
    page_bins: int = DEFAULT_PAGE_BINS
    # None = per-call default (REPRO_ENGINE_EXECUTOR, else the card when
    # the session's torch device is CUDA); "device" keeps batch occupancy
    # profiling on the card.
    profile_executor: Optional[str] = None
    drift_threshold: float = 0.15  # TV distance that triggers an evaluation
    hysteresis: float = 0.05       # re-arm band below the threshold
    cooldown_batches: int = 2      # min batches between evaluations
    horizon_queries: float = 1e6   # steady-state horizon of the switch rule
    rebuild_gate: bool = True      # False = retune-every-drift baseline


@dataclasses.dataclass
class ServingStats:
    """Counters the drift benchmark reads off."""

    batches: int = 0
    events: int = 0
    drift_events: int = 0          # triggers (armed + above threshold)
    retune_evaluations: int = 0    # solve-table evaluations run
    rebuilds: int = 0              # evaluations that switched the config


@dataclasses.dataclass(frozen=True)
class RetuneDecision:
    """One evaluated drift event: the Eq. 15/16-extension verdict."""

    ts: float
    tv: float
    io_current: float              # current config priced on the live sketch
    io_candidate: float            # retuned best on the live sketch
    rebuild_io: float              # modeled rebuild cost, in page I/Os
    predicted_savings: float       # (io_cur - io_new) * horizon
    switched: bool
    from_knob: object
    to_knob: object
    result: TuneResult


@dataclasses.dataclass(frozen=True)
class BatchReport:
    """Per-batch outcome of :meth:`ServingSession.ingest`."""

    ts: float
    n_queries: int
    tv: float
    drifted: bool
    decision: Optional[RetuneDecision]


class ServingSession:
    """Drift-aware serving of ONE index family on one key file.

    Construction fixes the candidate grid (budget-feasible knob points of
    ``builder``); :meth:`start` warms the sketch and deploys the initial
    configuration; :meth:`observe` / :meth:`ingest` then run the
    detect → retune → decide loop described in the module docstring.
    """

    def __init__(self, tuning: TuningSession, builder: IndexBuilder,
                 keys: np.ndarray, *,
                 overrides: Optional[Dict[str, object]] = None,
                 config: Optional[ServingConfig] = None,
                 size_model=None):
        self.tuning = tuning
        self.builder = builder
        self.keys = np.asarray(keys)
        self.config = config if config is not None else ServingConfig()
        self.space = builder.knob_space(overrides)
        size_model = size_model if size_model is not None \
            else builder.size_model()
        feasible, _skipped = _feasibility_split(
            self.space.points(), self.space, size_model, tuning.system)
        if not feasible:
            raise ValueError("memory budget too small for any candidate "
                             "index")
        self.candidates = [builder.candidate(pt, size)
                           for pt, size in feasible]
        self._size_of = {self.space.key(pt): size for pt, size in feasible}
        self.sketch = WindowSketch(
            tuning.cost, self.candidates,
            window_chunks=self.config.window_chunks,
            page_bins=self.config.page_bins,
            profile_executor=self.config.profile_executor)
        self.current: Optional[TuneResult] = None
        self.stats = ServingStats()
        self.decisions: List[RetuneDecision] = []
        self._baseline = None
        self._armed = False
        self._last_eval_tv = 0.0
        self._cooldown = 0

    # ----------------------------------------------------------------- start
    def start(self, warmup_events: Sequence[TraceEvent]) -> TuneResult:
        """Warm the sketch on an initial event prefix and deploy the tune.

        Even the initial tune runs from the sketch (``tune_from_profiles``),
        so the whole lifecycle shares one code path and the structural
        no-reprofile guarantee holds from the first event onward.
        """
        for batch in iter_batches(warmup_events, self.config.batch_size):
            self.sketch.update(compile_events(batch, self.keys))
        result = self._retune()
        self._deploy(result)
        return result

    # ---------------------------------------------------------------- ingest
    def observe(self, events: Sequence[TraceEvent]) -> List[BatchReport]:
        """Batch an event stream through :meth:`ingest`."""
        return [self.ingest(compile_events(batch, self.keys),
                            ts=batch[-1].ts)
                for batch in iter_batches(events, self.config.batch_size)]

    @obs.traced("serving.ingest")
    def ingest(self, workload: Workload, ts: float = 0.0) -> BatchReport:
        """One loop iteration: sketch update, drift check, maybe a retune."""
        if self.current is None:
            raise RuntimeError("ServingSession.start() must run before "
                               "ingest()")
        cfg = self.config
        self.sketch.update(workload)
        self.stats.batches += 1
        self.stats.events += workload.n_queries
        if self._cooldown > 0:
            self._cooldown -= 1
        with obs.span("serving.drift"):
            tv = tv_distance(self.sketch.summary(), self._baseline)
        if not self._armed and tv < cfg.drift_threshold - cfg.hysteresis:
            self._armed = True
        drifted = tv > cfg.drift_threshold and (
            self._armed or tv > self._last_eval_tv + cfg.hysteresis)
        decision = None
        if drifted and self._cooldown == 0:
            self.stats.drift_events += 1
            decision = self._evaluate(tv, ts)
        return BatchReport(ts=ts, n_queries=workload.n_queries, tv=tv,
                           drifted=drifted, decision=decision)

    # -------------------------------------------------------------- decision
    @obs.traced("serving.retune")
    def _retune(self) -> TuneResult:
        with obs.span("serving.merge"):
            profiles = self.sketch.to_profiles()
        return self.tuning.tune_from_profiles(
            self.builder, profiles, knob_space=self.space)

    def _deploy(self, result: TuneResult) -> None:
        self.current = result
        self._baseline = self.sketch.summary()
        self._armed = False
        self._last_eval_tv = 0.0
        self._cooldown = self.config.cooldown_batches

    def _evaluate(self, tv: float, ts: float) -> RetuneDecision:
        cfg = self.config
        result = self._retune()
        self.stats.retune_evaluations += 1
        io_new = float(result.est_io)
        io_cur = self._current_io(result)
        rebuild = self.rebuild_io(result)
        savings = (io_cur - io_new) * cfg.horizon_queries
        if cfg.rebuild_gate:
            switched = (result.best_knob != self.current.best_knob
                        and savings > rebuild)
        else:
            switched = True
        decision = RetuneDecision(
            ts=ts, tv=tv, io_current=io_cur, io_candidate=io_new,
            rebuild_io=rebuild, predicted_savings=savings,
            switched=switched, from_knob=self.current.best_knob,
            to_knob=result.best_knob, result=result)
        self.decisions.append(decision)
        self._armed = False
        self._last_eval_tv = tv
        self._cooldown = cfg.cooldown_batches
        if switched:
            self.stats.rebuilds += 1
            self._deploy(result)
        return decision

    def _current_io(self, result: TuneResult) -> float:
        """Price the DEPLOYED (knob, split) on the live sketch.

        Read off the freshly solved (knob x split) table — same capacities,
        zero extra model calls.  A deployed knob that fell out of the table
        (cannot happen with a fixed candidate grid, but be safe) prices as
        +inf, which always favors switching.
        """
        entries = result.table.get(self.current.best_knob)
        if not entries:
            return math.inf
        cap = self.current.capacity_pages
        return min(entries, key=lambda e: abs(e.capacity_pages - cap)).io

    def rebuild_io(self, result: TuneResult) -> float:
        """Modeled page I/Os to deploy ``result``'s best configuration.

        Key-file scan reads + index write I/O + cold-cache refill: the new
        steady state keeps ``min(capacity, distinct_pages)`` pages resident
        (``distinct_pages`` from the sketch solve — the live workload's
        touched-page footprint), and every one of them re-enters the buffer
        as a miss the old configuration would not have paid.
        """
        geom = self.tuning.system.geom
        scan_reads = geom.num_pages(int(self.keys.shape[0]))
        size_b = float(self._size_of.get(result.best_knob, 0.0))
        write_ios = math.ceil(size_b / geom.page_bytes)
        est = result.estimates[result.best_knob]
        refill = min(float(result.capacity_pages), est.distinct_pages)
        return float(scan_reads + write_ios + refill)
