"""Write-path benchmark: CAM-guided merge scheduling vs cache-oblivious.

The port's twin of the JAX package's ``benchmarks/bench_write_path.py``:
the same trace, sizes, arms, accounting and gates, run through
``repro_torch`` on a torch device.

A read-mostly -> write-burst -> read-mostly trace streams through three
:class:`~repro_torch.write.WriteSession` arms that differ ONLY in the merge
scheduler:

* ``cam``     — :class:`CamMergeScheduler`: merges when the priced miss
                penalty of deferral over the horizon exceeds the merge
                burst's own I/O (Eq. 15 with a time axis);
* ``every_k`` — merge every K ingested batches (period-tuned baseline);
* ``on_full`` — merge only when the delta buffer is full (defer-everything
                baseline; the delta keeps stealing buffer-pool pages, so
                reads pay the shrunken cache the whole trace).

Accounting is identical across arms: each batch is charged its reads times
the model-priced I/O/query at the CURRENT (delta-shrunken) capacity, plus
the sorted-burst I/O of every merge the arm performs.  Every decision event
costs exactly ONE ``PricingEngine.price`` call in every arm (held).

Two gates hold (the run fails otherwise): the CAM arm's total I/O is
>= 1.2x lower than merge-on-full, and no worse than merge-every-K.  The
record is printed as the last line of standard output (JSON).

    PYTHONPATH=src python -m repro_torch.launch.bench_write_path --smoke

Runs on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import json

import numpy as np

from repro_torch.core.cam import CamGeometry
from repro_torch.core.session import (DEFAULT_TORCH_DEVICE, GridCandidate,
                                      System)
from repro_torch.serving.trace import synthetic_drifting_trace
from repro_torch.write import (CamMergeScheduler, EveryKScheduler,
                               OnFullScheduler, WriteConfig, WriteSession)

GEOM = CamGeometry(c_ipp=64, page_bytes=4096)
MEMORY_PAGES = 160


def emit(name: str, us_per_call: float, derived: str):
    print(f"{name},{us_per_call:.1f},{derived}", flush=True)


def segments(scale: int):
    """Read-mostly -> write-burst -> read-mostly (hot set shifts with the
    burst, so deferral's shrunken cache hurts exactly when writes pile up)."""
    return [
        {"events": 8 * scale, "mix": (0.9, 0.05, 0.0, 0.05, 0.0, 0.0),
         "hot_center": 0.3, "hot_width": 0.08, "hot_frac": 0.95},
        {"events": 10 * scale, "mix": (0.2, 0.0, 0.0, 0.65, 0.1, 0.05),
         "hot_center": 0.7, "hot_width": 0.25, "hot_frac": 0.8},
        {"events": 16 * scale, "mix": (0.92, 0.05, 0.0, 0.03, 0.0, 0.0),
         "hot_center": 0.3, "hot_width": 0.08, "hot_frac": 0.95},
    ]


def measure(smoke: bool = False, seed: int = 0,
            torch_device: str = DEFAULT_TORCH_DEVICE) -> dict:
    """All three arms; the record with its gates (not asserted here)."""
    scale = 250 if smoke else 1000
    n = 100_000 if smoke else 400_000
    keys = np.sort(np.random.default_rng(seed + 1).uniform(0, 1e9, n))
    system = System(GEOM, memory_budget_bytes=(MEMORY_PAGES if smoke
                                               else 4 * MEMORY_PAGES)
                    * GEOM.page_bytes, policy="lru",
                    torch_device=torch_device)
    config = WriteConfig(batch_size=scale,
                         delta_capacity_entries=160 * scale,
                         delta_entry_bytes=192.0, horizon_batches=12.0)
    candidate = GridCandidate(knob="live", eps=64, size_bytes=4096.0)
    segs = segments(scale)
    events = synthetic_drifting_trace(keys, segs, seed=seed)

    arms = {}
    for sched in (CamMergeScheduler(), EveryKScheduler(k=8),
                  OnFullScheduler()):
        sess = WriteSession(keys, system, sched, candidate=candidate,
                            config=config)
        rep = sess.run(events)
        arms[rep.scheduler] = {
            **rep.summary(), "io_per_op": rep.total_io / len(events),
            "merged_batches": [r.batch_index for r in rep.records
                               if r.merged],
            "reasons": [r.reason for r in rep.records]}
        emit(f"write_path/{rep.scheduler}",
             1e6 * arms[rep.scheduler]["io_per_op"],
             f"total_io={rep.total_io:.0f} merges={rep.merges}")

    ratio_full = arms["on_full"]["total_io"] / arms["cam"]["total_io"]
    ratio_k = arms["every_k"]["total_io"] / arms["cam"]["total_io"]
    record = {
        "n": n, "events": len(events), "segments": segs, "smoke": smoke,
        "torch_device": str(torch_device),
        "memory_pages": int(system.memory_budget_bytes // GEOM.page_bytes),
        "config": {"batch_size": config.batch_size,
                   "delta_capacity_entries": config.delta_capacity_entries,
                   "delta_entry_bytes": config.delta_entry_bytes,
                   "horizon_batches": config.horizon_batches},
        "arms": arms,
        "on_full_over_cam_io": ratio_full,
        "every_k_over_cam_io": ratio_k,
        "gates": {
            "one_engine_call_per_decision_event": all(
                a["engine_calls"] == a["decision_events"]
                for a in arms.values()),
            "cam_1p2x_vs_on_full": ratio_full >= 1.2,
            "cam_no_worse_than_every_k": ratio_k >= 1.0,
        },
    }
    emit("write_path/ratio", 0.0,
         f"on_full/cam={ratio_full:.2f}x every_k/cam={ratio_k:.2f}x")
    return record


def check_gates(record: dict) -> None:
    gates = record["gates"]
    if not gates["one_engine_call_per_decision_event"]:
        raise RuntimeError("engine calls != decision events: " + str(
            {k: (a["engine_calls"], a["decision_events"])
             for k, a in record["arms"].items()}))
    if not gates["cam_1p2x_vs_on_full"]:
        raise RuntimeError(f"cam only {record['on_full_over_cam_io']:.2f}x "
                           "better than on_full (< 1.2x)")
    if not gates["cam_no_worse_than_every_k"]:
        raise RuntimeError(f"cam worse than every_k "
                           f"({record['every_k_over_cam_io']:.2f}x)")


def run(smoke: bool = False, seed: int = 0,
        torch_device: str = DEFAULT_TORCH_DEVICE) -> dict:
    """Measure the three arms and hold the gates; returns the record."""
    record = measure(smoke, seed, torch_device)
    check_gates(record)
    return record


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="CI-sized inputs (~seconds)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=DEFAULT_TORCH_DEVICE)
    args = ap.parse_args(argv)
    print("name,us_per_call,derived")
    record = run(smoke=args.smoke, seed=args.seed, torch_device=args.device)
    print(json.dumps(record, default=float))


if __name__ == "__main__":
    main()
