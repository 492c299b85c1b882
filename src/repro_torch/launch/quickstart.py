"""Quickstart: CAM through the index-agnostic CostSession API — estimate
physical I/O for THREE disk-resident learned indexes (PGM, RMI, RadixSpline)
WITHOUT replaying the workload, and check each against ground truth.

The port's twin of the JAX package's ``examples/quickstart.py``: the same
data, indexes, budget and printed lines, run through ``repro_torch`` on a
torch device.  ``run`` also returns the numbers it prints.

    PYTHONPATH=src python -m repro_torch.launch.quickstart --smoke

Runs on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import json

from repro_torch.core.cam import CamGeometry
from repro_torch.core.qerror import q_error
from repro_torch.core.replay import replay_windows
from repro_torch.core.session import (DEFAULT_TORCH_DEVICE, CostSession,
                                      System, resolve_torch_device)
from repro_torch.core.workload import Workload
from repro_torch.data.datasets import make_dataset
from repro_torch.data.workloads import WorkloadSpec, point_workload
from repro_torch.index.adapters import (PGMAdapter, RadixSplineAdapter,
                                        RMIAdapter)


def run(smoke: bool = False,
        torch_device: str = DEFAULT_TORCH_DEVICE) -> dict:
    resolve_torch_device(torch_device)   # refuse a missing card first
    n, q = (200_000, 20_000) if smoke else (1_000_000, 100_000)

    # 1. a sorted key set ("on disk") and a skewed point-lookup workload;
    #    the Workload locates true positions ONCE and caches them for every
    #    estimate that follows
    keys = make_dataset("books", n, seed=1)
    query_keys, _ = point_workload(keys, q, WorkloadSpec("w4", seed=3))
    workload = Workload.from_keys(keys, query_keys)

    # 2. the System: page geometry + a 2 MiB memory budget shared by index
    #    and buffer + LRU eviction
    system = System(geom=CamGeometry(c_ipp=256, page_bytes=4096),
                    memory_budget_bytes=2 << 20, policy="lru",
                    torch_device=torch_device)
    session = CostSession(system)

    # 3. three different index designs, ONE estimation surface
    out = {"n": n, "queries": q, "torch_device": str(torch_device),
           "families": {}}
    for adapter in (PGMAdapter.build(keys, eps=64),
                    RMIAdapter.build(keys, branch=4096),
                    RadixSplineAdapter.build(keys, eps=64, radix_bits=12)):
        est = session.estimate(adapter, workload)

        # ground truth: replay the actual last-mile windows through a real
        # buffer
        lo, hi = adapter.window(query_keys)
        capacity = max(1, system.capacity_for(adapter.size_bytes))
        misses = replay_windows(lo // system.geom.c_ipp,
                                hi // system.geom.c_ipp, capacity,
                                system.policy)
        qe = float(q_error(est.io_per_query, misses.mean()))
        print(f"{adapter.family:12s} ({adapter.size_bytes / 1024:7.1f} KiB, "
              f"knobs {adapter.knobs()!r}):")
        print(f"  CAM    {est.io_per_query:.4f} IO/query "
              f"(hit rate {est.hit_rate:.3f}) in "
              f"{est.estimation_seconds * 1e3:.0f} ms")
        print(f"  replay {misses.mean():.4f} IO/query   "
              f"Q-error {qe:.3f}\n")
        out["families"][adapter.family] = {
            "size_bytes": float(adapter.size_bytes),
            "knobs": adapter.knobs(), "capacity_pages": int(capacity),
            "est_io": float(est.io_per_query),
            "hit_rate": float(est.hit_rate),
            "estimation_seconds": float(est.estimation_seconds),
            "replay_io": float(misses.mean()), "q_error": qe}
    return out


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="CI-sized inputs (~5x below the demo default)")
    ap.add_argument("--device", default=DEFAULT_TORCH_DEVICE)
    args = ap.parse_args(argv)
    out = run(smoke=args.smoke, torch_device=args.device)
    print(json.dumps(out, default=float))
    return out


if __name__ == "__main__":
    main()
