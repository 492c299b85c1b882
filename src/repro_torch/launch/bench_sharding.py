"""Sharding benchmark: CAM-solved boundaries vs the even key split.

The port's twin of the JAX package's ``benchmarks/bench_sharding.py``: the
same hotspot, fleet, grids and gate, run through ``repro_torch`` on a torch
device.

A Zipf-flavored hotspot concentrates ~92% of the traffic in a key slab
WIDER than any single shard's maximal fleet-budget share, dropped inside
the even split's first shard.  The even key split therefore cannot cache
the hot set no matter how the budget simplex tilts toward the hot shard —
while boundary search can divide the slab across all nodes so the union
of their buffers covers it.  Both arms run the SAME joint solver (per-
shard knob and fleet budget split are optimized for each); only the
boundary candidate set differs:

* ``even``   — the even key split only (knob + budget still solved);
* ``solved`` — the full candidate grid (even + traffic quantiles +
  blends), one grouped profile pass + one solve pass for the whole
  (boundary × shard × knob × share) table.

Gate (held per policy, the run fails otherwise): solved boundaries beat
the even split by >= 1.15x fleet I/O under lru, fifo AND lfu.  The record
is printed as the last line of standard output (JSON).

    PYTHONPATH=src python -m repro_torch.launch.bench_sharding --smoke

Runs on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import json
import time

import numpy as np

from repro_torch.core.cam import CamGeometry
from repro_torch.core.session import DEFAULT_TORCH_DEVICE, System
from repro_torch.core.workload import Workload
from repro_torch.data.datasets import make_dataset
from repro_torch.sharding import ShardingSession, even_boundaries
from repro_torch.tuning.session import PGMBuilder

GEOM = CamGeometry(c_ipp=256, page_bytes=4096)
N_SHARDS = 4
BUDGET_GRID = 8
EPS_GRID = (8, 32, 128)
POLICIES = ("lru", "fifo", "lfu")
GATE_RATIO = 1.15


def emit(name: str, us_per_call: float, derived: str):
    print(f"{name},{us_per_call:.1f},{derived}", flush=True)


def hotspot_workload(n: int, nq: int, slab_pages: int,
                     hot_frac: float = 0.92, seed: int = 0) -> Workload:
    """~uniform hot slab of ``slab_pages`` pages + a uniform cold tail.

    The slab is kept flat on purpose: within-slab skew would let LFU/LRU
    pin the hottest pages under ANY boundaries, hiding the coverage
    effect the benchmark isolates.
    """
    rng = np.random.default_rng(seed)
    slab = slab_pages * GEOM.c_ipp
    hot = rng.integers(0, slab, int(nq * hot_frac))
    cold = rng.integers(0, n, nq - hot.shape[0])
    pos = np.concatenate([hot, cold])
    rng.shuffle(pos)
    return Workload.point(pos, n=n)


def measure(smoke: bool = False, seed: int = 0,
            torch_device: str = DEFAULT_TORCH_DEVICE) -> dict:
    """Both arms under every policy; the record with its gates (not
    asserted here)."""
    # the hot slab must overflow the max single-shard share:
    # fleet = N_SHARDS * node budget; max share = 5/8 of it
    if smoke:
        n, nq, node_kb, slab_pages = 40_000, 20_000, 32, 30
    else:
        n, nq, node_kb, slab_pages = 200_000, 100_000, 160, 150
    keys = make_dataset("books", n, seed=1)
    wl = hotspot_workload(n, nq, slab_pages, seed=seed)
    even = even_boundaries(n, N_SHARDS)
    builder = PGMBuilder(keys)

    policies, gates = {}, {}
    for policy in POLICIES:
        node = System(GEOM, memory_budget_bytes=node_kb << 10, policy=policy,
                      torch_device=torch_device)
        sess = ShardingSession(node, builder, N_SHARDS, grid=BUDGET_GRID,
                               overrides={"eps": EPS_GRID})
        t0 = time.perf_counter()
        solved = sess.solve(wl)
        solve_seconds = time.perf_counter() - t0
        even_plan = sess.solve(wl, [even])
        ratio = even_plan.io_per_query / solved.io_per_query
        policies[policy] = {
            "solved_io_per_query": solved.io_per_query,
            "even_io_per_query": even_plan.io_per_query,
            "even_over_solved": ratio,
            "boundaries": list(solved.boundaries),
            "fractions": list(solved.fractions),
            "eps": [p.knob for p in solved.shards],
            "capacities": [p.capacity_pages for p in solved.shards],
            "even_fractions": list(even_plan.fractions),
            "even_eps": [p.knob for p in even_plan.shards],
            "shard_masses": list(solved.shard_masses),
            "cells_solved": solved.cells_solved,
            "boundaries_searched": len(solved.boundaries_searched),
            "solve_seconds": solve_seconds,
        }
        gates[policy] = ratio >= GATE_RATIO
        emit(f"sharding/{policy}", 1e6 * solved.io_per_query,
             f"even/solved={ratio:.2f}x boundaries={solved.boundaries} "
             f"cells={solved.cells_solved}")

    record = {
        "n": n, "queries": nq, "n_shards": N_SHARDS,
        "budget_grid": BUDGET_GRID, "node_budget_kb": node_kb,
        "fleet_budget_kb": node_kb * N_SHARDS,
        "hot_slab_pages": slab_pages, "eps_grid": list(EPS_GRID),
        "smoke": smoke, "torch_device": str(torch_device),
        "policies": policies,
        "gates": {f"solved_{GATE_RATIO}x_vs_even_{p}": g
                  for p, g in gates.items()},
    }
    worst = min(policies[p]["even_over_solved"] for p in POLICIES)
    emit("sharding/ratio", 0.0,
         f"worst even/solved={worst:.2f}x over {POLICIES}")
    return record


def check_gates(record: dict) -> None:
    for policy in POLICIES:
        if not record["gates"][f"solved_{GATE_RATIO}x_vs_even_{policy}"]:
            raise RuntimeError(
                f"solved boundaries only "
                f"{record['policies'][policy]['even_over_solved']:.2f}x "
                f"better than the even split under {policy} "
                f"(< {GATE_RATIO}x)")


def run(smoke: bool = False, seed: int = 0,
        torch_device: str = DEFAULT_TORCH_DEVICE) -> dict:
    """Measure both arms under every policy and hold the gate."""
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
    record = run(smoke=args.smoke, seed=args.seed, torch_device=args.device)
    print(json.dumps(record, default=float))


if __name__ == "__main__":
    main()
