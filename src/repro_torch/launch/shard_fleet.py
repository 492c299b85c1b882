"""Fleet sharding: a 4-node fleet prices its joint configuration space,
then a hotspot develops and the rebalance gate decides.

The port's twin of the JAX package's ``examples/shard_fleet.py``: the same
fleet, traffic, seeds and printed lines, run through ``repro_torch`` on a
torch device.  ``run`` also returns the numbers it prints.

The fleet prices its whole joint (shard-boundary x per-shard eps x
fleet-budget-split) space in one grouped profile pass + one solve pass.
The rebalance gate moves the boundaries when horizon I/O savings repay
data movement plus index rebuilds plus cold-buffer refill, and refuses
when the hotspot is a short flash that could never amortize the move.
Gates (each raises ``RuntimeError``): MOVE on the sustained hotspot,
REFUSED on the flash.

    PYTHONPATH=src python -m repro_torch.launch.shard_fleet --smoke

Runs on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import json

import numpy as np

from repro_torch.core.cam import CamGeometry
from repro_torch.core.session import (DEFAULT_TORCH_DEVICE, System,
                                      resolve_torch_device)
from repro_torch.core.workload import Workload
from repro_torch.data.datasets import make_dataset
from repro_torch.sharding import ShardingSession
from repro_torch.tuning.session import PGMBuilder


def _rebalance_row(res):
    return {"hot_shard": int(res.hot_shard), "tv": float(res.tv),
            "io_current": float(res.io_current),
            "io_candidate": float(res.io_candidate),
            "move_io": float(res.move_io),
            "predicted_savings": float(res.predicted_savings),
            "switched": bool(res.switched)}


def run(smoke: bool = False,
        torch_device: str = DEFAULT_TORCH_DEVICE) -> dict:
    resolve_torch_device(torch_device)   # refuse a missing card first
    n, nq, node_kb, slab_pages = ((40_000, 20_000, 32, 30) if smoke
                                  else (200_000, 100_000, 160, 150))

    keys = make_dataset("books", n, seed=1)
    node = System(CamGeometry(c_ipp=256, page_bytes=4096),
                  memory_budget_bytes=node_kb << 10, policy="lru",
                  torch_device=torch_device)
    fleet = ShardingSession(node, PGMBuilder(keys), n_shards=4, grid=8,
                            overrides={"eps": (8, 32, 128)})
    rng = np.random.default_rng(7)

    def traffic(hot_slab_pages=0, hot_frac=0.92, center=0.0):
        """Uniform traffic, optionally with a hot slab at ``center``."""
        if not hot_slab_pages:
            return Workload.point(rng.integers(0, n, nq), n=n)
        slab = hot_slab_pages * node.geom.c_ipp
        lo = min(max(0, int(center * n) - slab // 2), n - slab)
        hot = rng.integers(lo, lo + slab, int(nq * hot_frac))
        cold = rng.integers(0, n, nq - hot.shape[0])
        pos = np.concatenate([hot, cold])
        rng.shuffle(pos)
        return Workload.point(pos, n=n)

    # ---- day 0: balanced traffic, solve the joint fleet configuration ----
    plan = fleet.solve(traffic())
    print(f"fleet of {plan.n_shards} nodes, "
          f"{fleet.fleet_budget_bytes / 1024:.0f} KiB pooled budget, "
          f"{len(plan.boundaries_searched)} boundary candidates, "
          f"{plan.cells_solved} cells in one solve")
    print(f"  boundaries {plan.boundaries}  est {plan.io_per_query:.4f} IO/q")
    for sp in plan.shards:
        print(f"    shard {sp.index}: eps={sp.knob}  "
              f"share={sp.fraction:.3f}  {sp.capacity_pages} buffer pages  "
              f"mass={plan.shard_masses[sp.index]:.2f}")
    day0 = {"boundaries": [int(b) for b in plan.boundaries],
            "io_per_query": float(plan.io_per_query),
            "cells_solved": int(plan.cells_solved),
            "knobs": [sp.knob for sp in plan.shards],
            "fractions": [float(sp.fraction) for sp in plan.shards]}

    # ---- a hotspot develops: most traffic crowds into shard 0's range ----
    hot = traffic(hot_slab_pages=slab_pages)
    res = fleet.rebalance(hot, plan, horizon_queries=50 * nq)
    print(f"\nhotspot: shard {res.hot_shard} is hot (TV={res.tv:.2f}); "
          f"keep boundaries -> {res.io_current:.4f} IO/q, "
          f"move -> {res.io_candidate:.4f} IO/q")
    print(f"  move cost {res.move_io:.0f} IOs vs horizon savings "
          f"{res.predicted_savings:.0f} -> "
          f"{'MOVE' if res.switched else 'stay'}")
    if not res.switched:
        raise RuntimeError("a sustained hotspot should repay the boundary "
                           "move")
    plan = res.plan
    print(f"  new boundaries {plan.boundaries}, "
          f"shares {tuple(round(f, 3) for f in plan.fractions)}")
    hotspot = dict(_rebalance_row(res),
                   boundaries=[int(b) for b in plan.boundaries])

    # ---- a short flash: the hot set blips to the far end of the keys -----
    flash = fleet.rebalance(traffic(hot_slab_pages=slab_pages, center=0.8),
                            plan, horizon_queries=0.01 * nq)
    print(f"\nflash: hot set blips to shard {flash.hot_shard} for "
          f"~{0.01 * nq:.0f} queries: savings "
          f"{flash.predicted_savings:.0f} vs move {flash.move_io:.0f} "
          f"-> {'MOVE' if flash.switched else 'REFUSED'}")
    if flash.switched:
        raise RuntimeError("a flash can never amortize data movement")
    print("\nthe gate moved boundaries for the sustained hotspot and "
          "refused the flash.")
    return {"n": n, "queries": nq, "node_kb": node_kb,
            "torch_device": str(torch_device), "day0": day0,
            "hotspot": hotspot, "flash": _rebalance_row(flash)}


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
