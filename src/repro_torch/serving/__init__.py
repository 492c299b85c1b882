"""Serving layer — live-trace ingestion, incremental workload sketches, and
drift-triggered rebuild-cost-aware retuning.

Three layers, one direction of data flow:

* :mod:`repro_torch.serving.trace` — the op-log frontend:
  :class:`TraceEvent` (point / range / sorted probe, timestamped), JSONL
  parsing, batching, and compilation of event batches into
  :class:`~repro_torch.core.workload.Workload` parts through the existing
  ``locate``/``from_keys`` path;
* :mod:`repro_torch.serving.sketch` — :class:`WindowSketch`, the
  sliding-window workload sketch: ring-buffered per-batch profile chunks
  whose merge is associative (so eviction is subtraction-free), exposing
  ``to_profiles()`` views that plug straight into
  ``CostSession.solve_profiles`` — no trace replay, ever;
* :mod:`repro_torch.serving.session` — :class:`ServingSession`, the loop that
  consumes the stream, watches sketch divergence (TV distance with
  hysteresis), retunes from the live sketch via
  ``TuningSession.tune_from_profiles``, and switches configurations only
  when the rebuild-cost-aware extension of Eq. 15/16 says the steady-state
  I/O savings repay the rebuild I/O.
"""
from repro_torch.serving.session import (RetuneDecision, ServingConfig,
                                         ServingSession, ServingStats)
from repro_torch.serving.sketch import WindowSketch, tv_distance
from repro_torch.serving.trace import (TraceEvent, compile_events,
                                       iter_batches, parse_jsonl,
                                       synthetic_drifting_trace)

__all__ = [
    "TraceEvent", "parse_jsonl", "iter_batches", "compile_events",
    "synthetic_drifting_trace",
    "WindowSketch", "tv_distance",
    "ServingSession", "ServingConfig", "ServingStats", "RetuneDecision",
]
