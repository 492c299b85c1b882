"""Drift-aware serving: a live trace streams through ``ServingSession``.

The port's twin of the JAX package's ``examples/serve_adaptive.py``: the
same trace, knobs, thresholds and printed lines, run through
``repro_torch`` on a torch device.  ``run`` also returns the numbers it
prints.

The session sketches the workload in a sliding window (no replay —
per-batch profile chunks merge associatively), watches TV divergence
against the sketch the deployed knob was tuned on, retunes the joint
(eps x split) search FROM THE SKETCH on drift, and rebuilds only when the
Eq. 15/16 extension says steady-state I/O savings over the horizon repay
the modeled rebuild I/O (key-file scan + index write + cold-cache
refill).  Gate (raises ``RuntimeError``): the trace triggers at least one
retune.

    PYTHONPATH=src python -m repro_torch.launch.serve_adaptive --smoke

Runs on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import json

from repro_torch.core.cam import CamGeometry
from repro_torch.core.session import (DEFAULT_TORCH_DEVICE, System,
                                      resolve_torch_device)
from repro_torch.data.datasets import make_dataset
from repro_torch.serving import (ServingConfig, ServingSession,
                                 synthetic_drifting_trace)
from repro_torch.tuning.session import PGMBuilder, TuningSession


def run(smoke: bool = False,
        torch_device: str = DEFAULT_TORCH_DEVICE) -> dict:
    resolve_torch_device(torch_device)   # refuse a missing card first
    n, scale = (50_000, 256) if smoke else (200_000, 1024)

    keys = make_dataset("books", n, seed=1)
    system = System(CamGeometry(c_ipp=256, page_bytes=4096),
                    memory_budget_bytes=512 << 10, policy="lru",
                    torch_device=torch_device)
    serving = ServingSession(
        TuningSession(system), PGMBuilder(keys), keys,
        overrides={"eps": (8, 32, 128, 512)},
        config=ServingConfig(batch_size=scale, window_chunks=4,
                             drift_threshold=0.12, hysteresis=0.04,
                             horizon_queries=64 * scale))

    # a three-act trace: stable hot points -> hot-set flash -> wide ranges
    events = synthetic_drifting_trace(keys, [
        {"events": 6 * scale, "mix": (0.8, 0.2, 0.0), "hot_center": 0.2,
         "hot_width": 0.05, "range_width": 16},
        {"events": 2 * scale, "mix": (0.8, 0.2, 0.0), "hot_center": 0.6,
         "hot_width": 0.05, "range_width": 16},
        {"events": 8 * scale, "mix": (0.1, 0.7, 0.2), "hot_center": 0.75,
         "hot_width": 0.4, "range_width": 2048},
    ], seed=7)

    warmup, stream = events[:4 * scale], events[4 * scale:]
    initial = serving.start(warmup)
    print(f"deployed from warmup sketch: eps={initial.best_knob} "
          f"(split {initial.split:.2f}, {initial.capacity_pages} buffer "
          f"pages, est {initial.est_io:.4f} IO/q)")

    decisions = []
    for report in serving.observe(stream):
        line = (f"t={report.ts:6.0f}  batch of {report.n_queries:4d}  "
                f"TV={report.tv:.3f}")
        d = report.decision
        if d is None:
            print(line + ("  drift!" if report.drifted else ""))
            continue
        verdict = ("REBUILD" if d.switched else "keep   ")
        print(f"{line}  {verdict} eps {d.from_knob}->{d.to_knob}  "
              f"io {d.io_current:.4f}->{d.io_candidate:.4f}  "
              f"savings {d.predicted_savings:7.1f} vs rebuild "
              f"{d.rebuild_io:5.0f} IOs")
        decisions.append({"ts": float(report.ts), "switched": bool(d.switched),
                          "from_knob": d.from_knob, "to_knob": d.to_knob,
                          "io_current": float(d.io_current),
                          "io_candidate": float(d.io_candidate),
                          "predicted_savings": float(d.predicted_savings),
                          "rebuild_io": float(d.rebuild_io)})

    s = serving.stats
    print(f"\n{s.batches} batches, {s.events} events: {s.drift_events} "
          f"drift triggers, {s.retune_evaluations} sketch-retunes, "
          f"{s.rebuilds} rebuilds")
    if not s.retune_evaluations > 0:
        raise RuntimeError("trace should trigger at least one retune")
    cur = serving.current
    print(f"serving eps={cur.best_knob} at split {cur.split:.2f} "
          f"({cur.capacity_pages} pages)")
    return {"n": n, "batch_size": scale, "torch_device": str(torch_device),
            "initial": {"eps": initial.best_knob,
                        "split": float(initial.split),
                        "capacity_pages": int(initial.capacity_pages),
                        "est_io": float(initial.est_io)},
            "batches": s.batches, "events": s.events,
            "drift_events": s.drift_events,
            "retune_evaluations": s.retune_evaluations,
            "rebuilds": s.rebuilds, "decisions": decisions,
            "final": {"eps": cur.best_knob, "split": float(cur.split),
                      "capacity_pages": int(cur.capacity_pages)}}


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="CI-sized inputs (~4x below the demo default)")
    ap.add_argument("--device", default=DEFAULT_TORCH_DEVICE)
    args = ap.parse_args(argv)
    out = run(smoke=args.smoke, torch_device=args.device)
    print(json.dumps(out, default=float))
    return out


if __name__ == "__main__":
    main()
