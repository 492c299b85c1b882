"""Write-path quickstart: serving an update-heavy trace with CAM-guided
merges.

The port's twin of the JAX package's ``examples/update_heavy.py``: the same
keys, trace, schedulers and printed lines, run through ``repro_torch`` on
a torch device.  ``run`` also returns the numbers it prints.

``WriteSession`` drives the write pipeline over a live read/write op log:
mutations are staged in a memory-resident delta buffer (free now, but
every staged entry steals a buffer-pool page); each batch boundary builds
ONE three-cell PriceTable (the live read mix at the shrunken capacity, the
same mix at the restored capacity, and the pending merge's sorted burst)
and makes ONE ``PricingEngine.price`` call; ``CamMergeScheduler`` merges
when deferral's priced miss penalty over the horizon exceeds the burst's
own I/O.  ``EveryKScheduler`` and ``OnFullScheduler`` show what
cache-oblivious scheduling costs.  Gate (raises ``RuntimeError``): one
engine call per decision event, for every scheduler.

    PYTHONPATH=src python -m repro_torch.launch.update_heavy --smoke

Runs on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import json

import numpy as np

from repro_torch.core.cam import CamGeometry
from repro_torch.core.session import (DEFAULT_TORCH_DEVICE, GridCandidate,
                                      System, resolve_torch_device)
from repro_torch.serving.trace import synthetic_drifting_trace
from repro_torch.write import (CamMergeScheduler, EveryKScheduler,
                               OnFullScheduler, WriteConfig, WriteSession)


def run(smoke: bool = False,
        torch_device: str = DEFAULT_TORCH_DEVICE) -> dict:
    resolve_torch_device(torch_device)   # refuse a missing card first
    scale, n = (250, 100_000) if smoke else (600, 250_000)

    geom = CamGeometry(c_ipp=64, page_bytes=4096)
    keys = np.sort(np.random.default_rng(1).uniform(0, 1e9, n))
    system = System(geom, memory_budget_bytes=160 * geom.page_bytes,
                    policy="lru", torch_device=torch_device)
    config = WriteConfig(batch_size=scale,
                         delta_capacity_entries=160 * scale,
                         delta_entry_bytes=192.0, horizon_batches=12.0)
    candidate = GridCandidate(knob="live", eps=64, size_bytes=4096.0)

    # read-mostly -> update burst -> read-mostly: the regime where merge
    # timing decides the bill
    events = synthetic_drifting_trace(keys, [
        {"events": 8 * scale, "mix": (0.9, 0.05, 0.0, 0.05, 0.0, 0.0),
         "hot_center": 0.3, "hot_width": 0.08, "hot_frac": 0.95},
        {"events": 10 * scale, "mix": (0.2, 0.0, 0.0, 0.25, 0.5, 0.05),
         "hot_center": 0.7, "hot_width": 0.25, "hot_frac": 0.8},
        {"events": 16 * scale, "mix": (0.92, 0.05, 0.0, 0.01, 0.02, 0.0),
         "hot_center": 0.3, "hot_width": 0.08, "hot_frac": 0.95},
    ], seed=0)
    n_writes = sum(1 for e in events
                   if e.op in ("insert", "update", "delete"))
    print(f"{len(events)} events ({n_writes} writes) over {n // 1000}k "
          f"keys, {system.memory_budget_bytes // geom.page_bytes} buffer "
          "pages\n")

    print(f"{'scheduler':9s} {'total I/O':>10s} {'read I/O':>10s} "
          f"{'merge I/O':>10s} {'merges':>6s} {'engine calls':>12s}")
    reports = {}
    for sched in (CamMergeScheduler(), EveryKScheduler(k=8),
                  OnFullScheduler()):
        sess = WriteSession(keys, system, sched, candidate=candidate,
                            config=config)
        rep = sess.run(events)
        reports[rep.scheduler] = rep
        if rep.engine_calls != rep.decision_events:   # ONE price call/event
            raise RuntimeError(
                f"{rep.scheduler}: {rep.engine_calls} engine calls for "
                f"{rep.decision_events} decision events")
        print(f"{rep.scheduler:9s} {rep.total_io:10.1f} {rep.read_io:10.1f} "
              f"{rep.merge_io:10.1f} {rep.merges:6d} {rep.engine_calls:12d}")

    cam, full = reports["cam"], reports["on_full"]
    print(f"\nCAM-guided merging: {full.total_io / cam.total_io:.2f}x less "
          f"total I/O than merge-on-full "
          f"({cam.merges} priced merges vs {full.merges}).")
    first = next(r for r in cam.records if r.merged)
    print(f"first CAM merge at batch {first.batch_index}: deferral cost "
          f"{first.io_defer:.3f} io/q at C(d)={first.cap_now} vs "
          f"{first.io_merged:.3f} at C(0)={first.cap_empty}, "
          f"burst={first.merge_io:.0f} io -> '{first.reason}'")
    return {"events": len(events), "writes": n_writes, "n": n,
            "torch_device": str(torch_device),
            "schedulers": {name: {"total_io": float(r.total_io),
                                  "read_io": float(r.read_io),
                                  "merge_io": float(r.merge_io),
                                  "merges": int(r.merges),
                                  "engine_calls": int(r.engine_calls),
                                  "decision_events": int(r.decision_events)}
                           for name, r in reports.items()},
            "on_full_over_cam": float(full.total_io / cam.total_io),
            "first_cam_merge": {"batch": int(first.batch_index),
                                "io_defer": float(first.io_defer),
                                "io_merged": float(first.io_merged),
                                "cap_now": int(first.cap_now),
                                "cap_empty": int(first.cap_empty),
                                "merge_io": float(first.merge_io),
                                "reason": first.reason}}


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
