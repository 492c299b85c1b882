"""Fig. 11: end-to-end join through the JoinSession plan API.

The port's twin of the JAX package's ``benchmarks/bench_join.py``: the same
four sections, sizes, seeds and printed lines, run through ``repro_torch``
on a torch device.

* fig11/*    — INLJ vs POINT-ONLY vs RANGE-ONLY vs HYBRID across the w1-w6
               outer mixtures, all executed as plans of one JoinSession;
               ``choose`` column records whether CAM-predicted selection
               matched the replayed best.  The record carries the paper's
               8.8x beside each ``hybrid_speedup_vs_inlj`` (recorded, not
               gated: the machine is simulated).
* mix/*      — Workload.mixed read-blend outer streams (sorted-run / point
               blends).
* partition/ — vectorized Algorithm 2 vs the per-probe Python loop on the
               probe stream; the two must give identical segments (a gate
               that raises ``RuntimeError``), the speedup is recorded.
* tree/      — 3-level JoinTreeSession under ONE shared buffer pool: the
               solved budget split + per-level strategies vs a naive even
               split vs the exhaustive-replay best.

The record is printed as the last line of standard output (JSON), and
written to a file only when ``out_path`` is given.

    PYTHONPATH=src python -m repro_torch.launch.bench_join --smoke

Runs on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import json
import time
from itertools import combinations

import numpy as np

from repro_torch.core.session import (DEFAULT_TORCH_DEVICE, System,
                                      resolve_torch_device)
from repro_torch.core.workload import Workload, locate
from repro_torch.data.workloads import WorkloadSpec, join_outer_keys
from repro_torch.index.adapters import PGMAdapter
from repro_torch.join.hybrid import partition_probes, partition_probes_loop
from repro_torch.join.session import STRATEGIES, JoinSession
from repro_torch.join.tree import JoinTreeSession
from repro_torch.launch.bench_common import GEOM, dataset, emit, main_for

BUFFER_MB = 2          # paper: 16MB vs 200M rows; scaled ~1:10
#: The paper's headline: the hybrid join up to 8.8x faster than INLJ.
PAPER_HYBRID_SPEEDUP = 8.8
WORKLOADS = ("w1", "w2", "w3", "w4", "w5", "w6")
SORTED_FRACS = (0.0, 0.5, 0.9)


def _session(keys, eps, torch_device):
    inner = PGMAdapter.build(keys, eps)
    system = System(GEOM, memory_budget_bytes=(BUFFER_MB << 20)
                    + inner.size_bytes, policy="lru",
                    torch_device=torch_device)
    s = JoinSession(inner, system, inner_keys=keys)
    s.calibrate()
    return s


def _mixed_outer(keys, n_outer, sorted_frac, seed=9):
    """Read-blend outer stream: a contiguous sorted run + mixture points."""
    rng = np.random.default_rng(seed)
    n_run = int(n_outer * sorted_frac)
    parts = []
    if n_outer - n_run:
        qk = join_outer_keys(keys, n_outer - n_run, WorkloadSpec("w4", seed=seed))
        parts.append(Workload.point(locate(keys, qk), n=len(keys),
                                    query_keys=qk))
    if n_run:
        start = int(rng.integers(0, max(1, len(keys) - n_run)))
        run = keys[start:start + n_run]
        parts.append(Workload.point(locate(keys, run), n=len(keys),
                                    query_keys=run))
    return Workload.mixed(*parts)


def _choose_and_replay(session, outer):
    """(choice, replayed stats per strategy, replayed best, ratio)."""
    res = session.choose(outer, n_min=128, k_max=4096)
    stats = {s: session.execute(res.plans[s]) for s in STRATEGIES}
    best = min(stats, key=lambda s: stats[s].seconds)
    ratio = stats[res.strategy].seconds / max(stats[best].seconds, 1e-12)
    return res, stats, best, ratio


def _strategy_rows(stats):
    return {s: {"seconds": st.seconds, "physical_ios": int(st.physical_ios),
                "segments": int(st.n_segments),
                "range_segments": int(st.n_range_segments),
                "matches": int(st.matches)} for s, st in stats.items()}


def _fig11(session, keys, n_outer):
    out = {}
    for wl in WORKLOADS:
        outer = join_outer_keys(keys, n_outer, WorkloadSpec(wl, seed=9))
        res, stats, best, ratio = _choose_and_replay(session, outer)
        hy = stats["hybrid"]
        speedup = stats["inlj"].seconds / max(hy.seconds, 1e-12)
        emit(f"fig11/{wl}", 0.0,
             ";".join(f"{k}={v.seconds:.4f}s(io={v.physical_ios})"
                      for k, v in stats.items())
             + f";choose={res.strategy}(best={best},ratio={ratio:.2f})"
             + f";hybrid_speedup_vs_inlj={speedup:.2f}x"
             + f";range_segs={hy.n_range_segments}/{hy.n_segments}")
        out[wl] = {"strategies": _strategy_rows(stats),
                   "choose": res.strategy, "best": best, "ratio": ratio,
                   "hybrid_speedup_vs_inlj": speedup,
                   "paper_hybrid_speedup": PAPER_HYBRID_SPEEDUP,
                   "range_segments": int(hy.n_range_segments),
                   "segments": int(hy.n_segments)}
    return out


def _mix(session, keys, n_outer):
    out = {}
    for frac in SORTED_FRACS:
        outer = _mixed_outer(keys, n_outer, frac)
        res, stats, best, ratio = _choose_and_replay(session, outer)
        name = f"sorted{int(frac * 100):02d}"
        emit(f"mix/{name}", 0.0,
             f"choose={res.strategy};best={best};ratio={ratio:.2f};"
             + ";".join(f"{k}={v.seconds:.4f}s" for k, v in stats.items()))
        out[name] = {"choose": res.strategy, "best": best, "ratio": ratio,
                     "seconds": {k: v.seconds for k, v in stats.items()}}
    return out


def _partition(session, keys, n_outer):
    outer = join_outer_keys(keys, n_outer, WorkloadSpec("w4", seed=9))
    plan = session.plan(outer, "hybrid", n_min=128, k_max=4096)
    plo, phi = plan.page_lo, plan.page_hi
    p = session.params
    t0 = time.perf_counter()
    segs_v = partition_probes(plo, phi, p, n_min=128, k_max=4096)
    t_vec = time.perf_counter() - t0
    t0 = time.perf_counter()
    segs_l = partition_probes_loop(plo, phi, p, n_min=128, k_max=4096)
    t_loop = time.perf_counter() - t0
    identical = segs_v == segs_l
    record = {"n_probes": int(plo.shape[0]), "segments": len(segs_v),
              "loop_seconds": t_loop, "vectorized_seconds": t_vec,
              "speedup": t_loop / max(t_vec, 1e-12), "identical": identical}
    emit("partition/vectorized_vs_loop", t_vec * 1e6,
         f"speedup={record['speedup']:.1f}x;segments={len(segs_v)};"
         f"identical={identical}")
    if not identical:
        raise RuntimeError("vectorized Algorithm 2 and the per-probe loop "
                           "gave different segments")
    return record


def _tree(keys, n, torch_device):
    # Sparse outer probes + LFU make strategy choice capacity-dependent,
    # so the pool split genuinely matters; see launch/join_tree.py.
    tree_keys = [keys, keys[::2].copy(), keys[::3].copy()]
    tree_adapters = [PGMAdapter.build(k, 32) for k in tree_keys]
    idx_bytes = sum(a.size_bytes for a in tree_adapters)
    pool_pages = max(256, GEOM.num_pages(n) // 5)
    tree_outer = join_outer_keys(keys, max(800, n // 250),
                                 WorkloadSpec("w2", seed=9))
    grid = 8
    system = System(GEOM, memory_budget_bytes=pool_pages * GEOM.page_bytes
                    + idx_bytes, policy="lfu", torch_device=torch_device)
    tree = JoinTreeSession(tree_adapters, system, tree_keys)
    t0 = time.perf_counter()
    plan = tree.plan(tree_outer, grid=grid, objective="io",
                     n_min=64, k_max=4096)
    t_plan = time.perf_counter() - t0
    stats = tree.execute(plan)

    streams = tree.probe_streams(tree_outer)
    params = tree.sessions[0].params
    # even-split baseline: same pool split 1/L, per-level strategy still
    # chosen by predicted io (same objective as the tree plan, so the
    # recorded ratio isolates what the budget-split SOLVE buys)
    even_cap = max(1, tree.pool_pages // tree.n_levels)
    even_io = 0
    for i, sess in enumerate(tree.sessions):
        curve = sess.cost_curve(streams[i], [even_cap], n_min=64,
                                k_max=4096, params=params)
        strategy, _ = curve.best_at(0, "io")
        even_io += sess.execute(sess.plan(streams[i], strategy, n_min=64,
                                          k_max=4096, params=params,
                                          capacity=even_cap)).physical_ios

    # exhaustive-replay best over (split simplex x per-level strategy):
    # levels are independent given the split, so replay each
    # (level, capacity, strategy) once and minimize over compositions.
    shares = np.arange(1, grid - tree.n_levels + 2)
    caps = np.maximum(1, (shares * tree.pool_pages) // grid)
    io_tab = np.empty((tree.n_levels, len(caps)))
    for lvl, sess in enumerate(tree.sessions):
        for j, cap in enumerate(caps):
            io_tab[lvl, j] = min(
                sess.execute(sess.plan(streams[lvl], st, n_min=64,
                                       k_max=4096, params=params,
                                       capacity=int(cap))).physical_ios
                for st in STRATEGIES)
    bars = np.array(list(combinations(range(1, grid), tree.n_levels - 1)))
    edges = np.concatenate(
        [np.zeros((bars.shape[0], 1), np.int64), bars,
         np.full((bars.shape[0], 1), grid)], axis=1)
    comps = np.diff(edges, axis=1)
    best_io = float(io_tab[np.arange(tree.n_levels)[None, :],
                           comps - 1].sum(axis=1).min())

    record = {"n_inner": n, "n_outer": int(tree_outer.shape[0]),
              "pool_pages": tree.pool_pages, "grid": grid, "policy": "lfu",
              "fractions": list(plan.fractions),
              "strategies": list(plan.strategies),
              "plan_seconds": t_plan,
              "chosen_io": int(stats.physical_ios),
              "even_split_io": int(even_io),
              "best_replay_io": best_io,
              "chosen_vs_best": stats.physical_ios / max(best_io, 1.0),
              "even_vs_chosen": even_io / max(stats.physical_ios, 1)}
    emit("tree/split_vs_even", t_plan * 1e6,
         f"chosen_io={stats.physical_ios};even_io={even_io};"
         f"best_replay_io={best_io:.0f};"
         f"chosen_vs_best={record['chosen_vs_best']:.2f};"
         f"split={'/'.join(f'{f:.3f}' for f in plan.fractions)};"
         f"strategies={'/'.join(plan.strategies)}")
    return record


def run(n=4_000_000, n_outer=30_000, eps=64, out_path=None,
        torch_device=DEFAULT_TORCH_DEVICE) -> dict:
    resolve_torch_device(torch_device)   # refuse a missing card first
    keys = dataset("books", n)
    session = _session(keys, eps, torch_device)
    record = {"n": n, "n_outer": n_outer, "eps": eps,
              "buffer_mb": BUFFER_MB, "torch_device": str(torch_device),
              "fig11": _fig11(session, keys, n_outer),
              "mix": _mix(session, keys, n_outer),
              "partition": _partition(session, keys, n_outer),
              "tree": _tree(keys, n, torch_device)}
    if out_path is not None:
        with open(out_path, "w") as f:
            json.dump(record, f, indent=2, default=float)
    return record


def main(argv=None):
    return main_for(run, __doc__, argv)


if __name__ == "__main__":
    main()
