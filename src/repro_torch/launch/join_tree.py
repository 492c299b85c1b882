"""Multi-way join tree under ONE buffer budget (paper §VI, extended).

The port's twin of the JAX package's ``examples/join_tree.py``: the same
three inner relations, pool, workloads and printed lines, run through
``repro_torch`` on a torch device.  ``run`` also returns the numbers it
prints.

A left-deep tree joins the outer stream through three inner relations (a
star join: the fact keys and two dimensions holding every 2nd / 3rd key).
Every inner index is resident, so the levels compete for the ONE buffer
pool the memory budget leaves behind.  ``JoinTreeSession.plan`` solves the
pool split and the per-level strategies jointly in one batched model
solve; ``execute`` replays the plan level by level.  Under LFU the
strategy crossover is capacity-dependent, so the printed comparison shows
what the solved split buys over a naive even split of the same pool.

    PYTHONPATH=src python -m repro_torch.launch.join_tree --smoke

Runs on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import json

from repro_torch.core.cam import CamGeometry
from repro_torch.core.session import (DEFAULT_TORCH_DEVICE, System,
                                      resolve_torch_device)
from repro_torch.data.datasets import make_dataset
from repro_torch.data.workloads import WorkloadSpec, join_outer_keys
from repro_torch.index.adapters import PGMAdapter
from repro_torch.join.tree import JoinTreeSession


def run(smoke: bool = False,
        torch_device: str = DEFAULT_TORCH_DEVICE) -> dict:
    resolve_torch_device(torch_device)   # refuse a missing card first
    pool_pages = 512 if smoke else 780
    workloads = ("w1",) if smoke else ("w1", "w2")
    n, n_outer = 200_000, 800

    base = make_dataset("books", n, seed=1)
    inner_keys = [base, base[::2].copy(), base[::3].copy()]
    adapters = [PGMAdapter.build(k, eps=32) for k in inner_keys]
    idx_bytes = sum(a.size_bytes for a in adapters)
    system = System(CamGeometry(),
                    memory_budget_bytes=pool_pages * 4096 + idx_bytes,
                    policy="lfu", torch_device=torch_device)

    tree = JoinTreeSession(adapters, system, inner_keys)
    params = tree.calibrate()
    print(f"3-level tree, {tree.pool_pages} shared buffer pages "
          f"(indexes {idx_bytes / 1024:.0f} KiB resident, LFU eviction)\n")

    out = {}
    for wl in workloads:
        outer = join_outer_keys(base, n_outer, WorkloadSpec(wl, seed=9))
        plan = tree.plan(outer, grid=8, n_min=64, k_max=4096)
        stats = tree.execute(plan)
        print(f"workload {wl} ({n_outer} outer keys):")
        for lvl, (pl, st) in enumerate(zip(plan.levels, stats.per_level)):
            print(f"  level {lvl}: {pl.outer_keys.shape[0]:5d} probes  "
                  f"{plan.fractions[lvl] * 100:4.1f}% pool "
                  f"({plan.capacities[lvl]:4d} pages)  "
                  f"{pl.strategy:11s} io={st.physical_ios}")
        print(f"  solved split: {stats.seconds:.4f}s, "
              f"io={stats.physical_ios}, matches={stats.matches} "
              f"(predicted {plan.cost.seconds:.4f}s)")

        # naive baseline: the same pool split evenly, strategies still
        # chosen
        streams = tree.probe_streams(outer)
        even_cap = max(1, tree.pool_pages // tree.n_levels)
        even_plans = [sess.choose(streams[i], n_min=64, k_max=4096,
                                  params=params, capacity=even_cap).plan
                      for i, sess in enumerate(tree.sessions)]
        even = [sess.execute(pl)
                for sess, pl in zip(tree.sessions, even_plans)]
        even_s = sum(st.seconds for st in even)
        even_io = sum(st.physical_ios for st in even)
        ratio = even_io / max(stats.physical_ios, 1)
        print(f"  even split:   {even_s:.4f}s, io={even_io} "
              f"({'/'.join(pl.strategy for pl in even_plans)})  "
              f"-> even/solved = {ratio:.2f}x io\n")
        out[wl] = {"fractions": list(plan.fractions),
                   "capacities": [int(c) for c in plan.capacities],
                   "strategies": list(plan.strategies),
                   "seconds": stats.seconds,
                   "predicted_seconds": plan.cost.seconds,
                   "physical_ios": int(stats.physical_ios),
                   "matches": int(stats.matches),
                   "even_seconds": even_s, "even_io": int(even_io),
                   "even_strategies": [pl.strategy for pl in even_plans],
                   "even_over_solved_io": ratio}
    return {"n": n, "n_outer": n_outer, "pool_pages": int(tree.pool_pages),
            "index_bytes": int(idx_bytes), "torch_device": str(torch_device),
            "workloads": out}


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="CI-sized inputs (smaller pool, one workload)")
    ap.add_argument("--device", default=DEFAULT_TORCH_DEVICE)
    args = ap.parse_args(argv)
    out = run(smoke=args.smoke, torch_device=args.device)
    print(json.dumps(out, default=float))
    return out


if __name__ == "__main__":
    main()
