#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) through CAM's main path
on one NVIDIA GPU, and hold its CUDA kernels against their plain versions.

Run from the root of a checkout::

    python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero and never
prints its last line):

1. device and build — ``nvidia-smi`` name and power limit, the kernels
   built from ``src/repro_torch/kernels/csrc`` with ``nvcc``;
2. kernels vs plain versions at small shapes, every variant;
3. the main path at the paper's §VII-A setup with one cut (20M books keys
   instead of 200M): 1M w4 point queries, 4 KiB pages, 256 keys per page,
   a 12.8 MiB budget (the paper's 128 MiB scaled by the same 1/10), LRU —
   ``TuningSession.tune`` for PGM and RMI, a multi-policy tune, and
   ``CostSession.estimate_grid`` on a mixed workload (points + a sorted
   range stream + updates).  Launch counters are zeroed just before and
   read just after;
4. kernels vs plain versions at the main path's shapes (every variant),
   with CUDA-event times, the plain version's time, the card's lower bound
   and, where one PyTorch call computes the same function, its time;
5. the main path again through the host executor on the same card, and a
   trace replay of the chosen PGM and RMI configurations (q-error < 1.4).

The line before the last is the per-kernel JSON summary; the last line is
``{"ok": true, "device": {...}}``.  ``--device cpu`` rehearses phases 3
and 5 on the CPU at a smaller ``--keys``/``--queries`` and exits non-zero
without a result.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PAPER_KEYS = 200_000_000
PAPER_BUDGET_MIB = 128.0
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
F32_FLOPS_PER_S = 67e12          # H100 SXM float32, outside the tensor cores
Q_ERROR_BOUND = 1.4
POLICIES = ("lru", "fifo", "lfu")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class SmokeFailure(RuntimeError):
    pass


def check(cond, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


# ---------------------------------------------------------------------------
# Timing and bounds
# ---------------------------------------------------------------------------

def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def bound(nbytes: float, ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# price_grid: inputs, comparison, work count
# ---------------------------------------------------------------------------

PRICE_ARGS = ("probs", "sorted_probs", "cov_desc", "f32s", "i32s", "caps_f",
              "caps_i", "ids", "wprobs", "wprobs_q")


def price_call(args, kwargs):
    """Normalize a recorded ``price_grid(policy, *arrays, **flags)`` call."""
    names = ("policy",) + PRICE_ARGS
    call = dict(zip(names, args))
    call.update({k: v for k, v in kwargs.items() if k in names})
    for n in PRICE_ARGS:
        call.setdefault(n, None)
    flags = {k: kwargs[k] for k in ("has_sorted", "has_write", "iters")
             if k in kwargs}
    flags.setdefault("has_write", False)
    flags.setdefault("iters", 64)
    return call, flags


def synthetic_price(torch, policy, has_sorted, has_write, dev, seed=0, k=6,
                    p=1031, c=5):
    """A small padded table packed as the DeviceExecutor packs it, with a
    no-sample row, padded cells and a tie between bit-identical rows."""
    import numpy as np
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 6, (k, p)).astype(np.float32)
    counts[:, rng.random(p) < 0.3] = 0.0
    counts[1] = counts[0]
    counts[3] = 0.0
    w = np.floor(counts * rng.random((k, p))).astype(np.float32)
    w[1] = w[0]
    sample = counts.sum(1)
    probs = counts / np.maximum(sample[:, None], 1e-30)
    wprobs = w / np.maximum(sample[:, None], 1e-30)
    nd = (counts > 0).sum(1)
    pmin = np.maximum(np.where(probs > 0, probs, np.inf).min(1), 1e-30)
    caps = np.stack([rng.permutation([n // 3, n // 2, n + 5, -1, 1])
                     for n in nd]).astype(np.int32)[:, :c]
    caps[1] = caps[0]
    ids = np.arange(k * c, dtype=np.int32).reshape(k, c)
    ids[1] = ids[0] + k * c
    ids[2, 3:] = 2**31 - 1
    f32s = np.zeros((k, 16), np.float32)
    i32s = np.zeros((k, 8), np.int32)
    f32s[:, 0], f32s[:, 1], f32s[:, 2], f32s[:, 3] = (sample, 1.5 * sample,
                                                      nd, pmin)
    f32s[:, 8] = 2.0
    i32s[:, 0] = nd
    i32s[:, 3] = rng.integers(0, 3, k)
    i32s[1, 3] = i32s[0, 3]
    cov = rng.integers(0, 4, (k, p)).astype(np.float32)
    cov[1] = cov[0]
    if has_sorted:
        f32s[:, 4] = cov.sum(1)
        f32s[:, 5] = 1.5 * f32s[:, 4]
        f32s[:, 6] = i32s[:, 1] = (cov > 0).sum(1)
        f32s[:, 7] = 3.0
        i32s[:, 2] = 4
    order = np.argsort(-probs, axis=1, kind="stable")
    arrays = dict(probs=probs, sorted_probs=-np.sort(-probs, axis=1),
                  cov_desc=-np.sort(-cov, axis=1), f32s=f32s, i32s=i32s,
                  caps_f=caps.astype(np.float32), caps_i=caps, ids=ids,
                  wprobs=wprobs if has_write else None,
                  wprobs_q=(np.take_along_axis(wprobs, order, axis=1)
                            if has_write else None))
    call = {n: None if v is None else torch.as_tensor(
        np.ascontiguousarray(v), device=dev) for n, v in arrays.items()}
    call["policy"] = policy
    return call, dict(has_sorted=has_sorted, has_write=has_write, iters=64)


def run_price(fn, call, flags):
    return fn(call["policy"], *(call[n] for n in PRICE_ARGS), **flags)


def compare_price(tpg, call, flags, tol_h: float):
    k_h, k_bv, k_bi = run_price(tpg.price_grid, call, flags)
    r_h, r_bv, r_bi = run_price(tpg.price_grid_ref, call, flags)
    err = float((k_h - r_h).abs().max())
    check(err <= tol_h, f"price_grid {call['policy']} {flags}: max |dh| "
                        f"{err:.3g} > {tol_h:g}")
    bi_k, bi_r = int(k_bi.reshape(-1)[0]), int(r_bi.reshape(-1)[0])
    if bi_k != bi_r:          # argmin agrees up to objective ties
        obj = ((1.0 - r_h) * call["f32s"][:, 8:9]).reshape(-1)
        ids = call["ids"].reshape(-1)
        v_k = float(obj[ids == bi_k][0])
        v_r = float(obj[ids == bi_r][0])
        check(abs(v_k - v_r) <= 1e-5 * max(abs(v_r), 1e-12) + tol_h,
              f"price_grid argmin {bi_k} vs {bi_r}: {v_k} vs {v_r}")
    return err


def price_work(call, flags):
    """(bytes the function must move, float32 operations its data needs)."""
    import numpy as np
    policy = call["policy"]
    lfu_read = policy in ("lfu", "multi")
    used = ["probs", "f32s", "i32s", "caps_f", "caps_i", "ids"]
    if lfu_read:
        used.append("sorted_probs")
        if flags["has_sorted"]:
            used.append("cov_desc")
    if flags["has_write"]:
        used.append("wprobs")
        if lfu_read:
            used.append("wprobs_q")
    nbytes = sum(call[n].numel() * call[n].element_size() for n in used)
    k, p = call["probs"].shape
    c = call["caps_i"].shape[1]
    nbytes += k * c * 4 + 12                        # h, best value and id
    i32s = call["i32s"].cpu().numpy()
    caps = call["caps_i"].cpu().numpy().astype(np.int64)
    modes = {"lru": 0, "fifo": 1, "lfu": 2}
    pol = i32s[:, 3] if policy == "multi" else np.full(k, modes[policy])
    w = flags["has_write"]
    per_step = np.where(pol == 0, 3, 5)             # occupancy + accumulate
    final = np.where(pol == 0, 4, 6) + (9 if w else 0)
    recency = (flags["iters"] * per_step + final) * p + (p if w else 0)
    lfu = (np.minimum(np.maximum(caps, 1), p) * (2 if w else 1)
           + (p if w else 0))
    if flags["has_sorted"]:
        lfu = lfu + np.minimum(np.maximum(caps, 0), p)
    ops = np.where(pol[:, None] == 2, lfu, recency[:, None]).sum()
    return float(nbytes), float(ops)


# ---------------------------------------------------------------------------
# profile_grid: inputs, comparison, work count, library call
# ---------------------------------------------------------------------------

def profile_call(args, kwargs):
    names = ("keys", "pages", "lut", "bands")
    call = dict(zip(names, args))
    call.update(kwargs)
    return call


def run_profile(fn, call):
    return fn(call["keys"], call["pages"], call["lut"], call["bands"],
              c_ipp=call["c_ipp"], pad=call["pad"])


def compare_profile(tprof, call, exact: bool):
    out_k = run_profile(tprof.profile_grid, call)
    out_r = run_profile(tprof.profile_grid_ref, call)
    err = float((out_k - out_r).abs().max())
    if exact:
        check(bool((out_k == out_r).all()),
              f"profile_grid integer mass not exact (max |d| {err:.3g})")
    else:
        scale = max(1.0, float(out_r.abs().max()))
        check(err / scale <= 2e-6,
              f"profile_grid max |d|/scale {err / scale:.3g} > 2e-6")
    return err


def profile_entries(torch, call):
    """Flattened (target, value) scatter entries of a profile call — the
    input of the equivalent ``index_add_``."""
    keys, lut = call["keys"], call["lut"]
    k_idx, q_idx = torch.nonzero(keys >= 0, as_tuple=True)
    key = keys[k_idx, q_idx].long()
    base = k_idx * call["pad"] + call["pages"].long()[q_idx]
    cls = key // call["c_ipp"]
    tgts, vals = [], []
    for ci in torch.unique(cls).tolist():
        sel_all = torch.nonzero(cls == ci, as_tuple=True)[0]
        lo, hi = (int(v) for v in call["bands"][ci].tolist())
        d = torch.arange(lo, hi + 1, device=keys.device)
        chunk = max(1, (1 << 25) // d.numel())
        for a in range(0, sel_all.numel(), chunk):
            sel = sel_all[a:a + chunk]
            v = lut[key[sel]][:, lo:hi + 1]
            nz = v != 0
            tgts.append((base[sel, None] + d)[nz])
            vals.append(v[nz])
    return torch.cat(tgts), torch.cat(vals)


def profile_work(torch, call):
    nbytes = sum(call[n].numel() * call[n].element_size()
                 for n in ("keys", "pages", "lut", "bands"))
    nbytes += call["keys"].shape[0] * call["pad"] * 4          # output
    nnz = (call["lut"] != 0).sum(dim=1)
    keys = call["keys"]
    adds = float(nnz[keys[keys >= 0].long()].sum())
    return float(nbytes), adds


def synthetic_profile(torch, np, tprof, dev, k, q, num_pages, c_ipp,
                      integer_mass, seed):
    """Mixed-eps profile operands; integer mass keeps slots >= 2*eps from
    both page edges so every LUT entry is 0 or 1."""
    rng = np.random.default_rng(seed)
    if integer_mass:
        eps_choices = [e for e in (1, 2, 4, 8, 16, 32) if 4 * e < c_ipp]
        emax = max(eps_choices)
        positions = (rng.integers(0, num_pages, q) * c_ipp
                     + rng.integers(2 * emax, c_ipp - 2 * emax, q))
    else:
        eps_choices = [1, 4, 16, 64, 256, 1024]
        positions = rng.integers(0, num_pages * c_ipp, q)
    eps_rows = rng.choice(eps_choices, size=(k, q)).astype(np.int64)
    captured = {}
    real = tprof.profile_grid

    def grab(*a, **kw):
        captured.update(profile_call(a, kw))
        return real(*a, **kw)

    tprof.profile_grid = grab
    try:
        tprof.point_page_refs_mixed_eps_grid(positions, eps_rows, c_ipp,
                                             num_pages, device=dev)
    finally:
        tprof.profile_grid = real
    return captured


# ---------------------------------------------------------------------------
# Recording the main path's kernel calls and phase times
# ---------------------------------------------------------------------------

class Recorder:
    """Keeps, per kernel variant, the main path call with the most work —
    the shapes phase 4 holds each kernel to."""

    def __init__(self):
        self.price = {}
        self.profile = None

    def install(self, tpg, tprof):
        real_price, real_profile = tpg.price_grid, tprof.profile_grid

        def price(*a, **kw):
            call, flags = price_call(a, kw)
            key = (call["policy"], bool(flags["has_sorted"]),
                   bool(flags["has_write"]))
            size = call["probs"].numel() * call["caps_i"].shape[1]
            if key not in self.price or size > self.price[key][0]:
                self.price[key] = (size, call, flags)
            return real_price(*a, **kw)

        def profile(*a, **kw):
            call = profile_call(a, kw)
            size = call["keys"].numel()
            if self.profile is None or size > self.profile[0]:
                self.profile = (size, call)
            return real_profile(*a, **kw)

        tpg.price_grid, tprof.profile_grid = price, profile
        return lambda: (setattr(tpg, "price_grid", real_price),
                        setattr(tprof, "profile_grid", real_profile))


class PhaseClock:
    """Wall seconds of the profile and price halves of every session call
    (each ends in a device synchronize, so device time is included)."""

    def __init__(self, torch, sync):
        self.torch, self.sync = torch, sync
        self.seconds = {"profile": 0.0, "price": 0.0}

    def wrap(self, owner, name, phase):
        real = getattr(owner, name)
        clock = self

        def timed(*a, **kw):
            t0 = time.perf_counter()
            out = real(*a, **kw)
            clock.sync()
            clock.seconds[phase] += time.perf_counter() - t0
            return out

        setattr(owner, name, timed)
        return lambda: setattr(owner, name, real)


# ---------------------------------------------------------------------------
# The main path
# ---------------------------------------------------------------------------

def build_world(args, torch_device):
    import numpy as np
    from repro_torch.core.cam import CamGeometry
    from repro_torch.core.session import System
    from repro_torch.core.workload import Workload
    from repro_torch.data.datasets import make_dataset
    from repro_torch.data.workloads import (WorkloadSpec, point_workload,
                                            range_workload)

    times = {}
    t0 = time.perf_counter()
    keys = make_dataset("books", args.keys, seed=args.seed)
    times["data"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    qk, qpos = point_workload(keys, args.queries,
                              WorkloadSpec("w4", seed=args.seed + 1))
    _, _, rlop, rhip = range_workload(keys, args.queries // 10,
                                      WorkloadSpec("w1", seed=args.seed + 2),
                                      64)
    times["locate"] = time.perf_counter() - t0
    n = len(keys)
    point = Workload.point(qpos, n=n, query_keys=qk)
    mixed = Workload.mixed(
        Workload.point(qpos, n=n),
        Workload.sorted_stream(np.sort(rlop), np.sort(rhip), n=n),
        Workload.update(qpos[::10], n=n))
    # the paper's budget/data ratio at this key count: 12.8 MiB at 20M keys
    budget = PAPER_BUDGET_MIB * 2**20 * args.keys / PAPER_KEYS
    system = System(CamGeometry(), budget, "lru", torch_device=torch_device)
    return dict(keys=keys, qk=qk, point=point, mixed=mixed, system=system,
                times=times, budget=budget)


def size_model_builds(world):
    """Fit the PGM size model and build the budget-feasible RMIs up front
    (the tuner would do both on first use) so their host time is its own
    phase."""
    from repro_torch.tuning.session import PGMBuilder, RMIBuilder

    system = world["system"]
    t0 = time.perf_counter()
    pgm, rmi = PGMBuilder(world["keys"]), RMIBuilder(world["keys"])
    pgm_size = pgm.size_model()
    pgm_size(eps=64)
    rmi_size = rmi.size_model()
    for pt in rmi.knob_space().points():
        if system.capacity_for(rmi_size(**pt)) >= 1:
            rmi.build(pt)
    return pgm, rmi, time.perf_counter() - t0


def run_main_path(world, pgm, rmi):
    """The four entry-point calls of the main path; returns their results."""
    from repro_torch.core.session import CostSession
    from repro_torch.tuning.session import TuningSession

    system = world["system"]
    ts = TuningSession(system)
    out = {"pgm": ts.tune(pgm, world["point"]),
           "rmi": ts.tune(rmi, world["point"]),
           "multi": ts.tune(pgm, world["point"], policies=POLICIES)}
    out["mixed"] = CostSession(system).estimate_grid(
        mixed_candidates(pgm), world["mixed"])
    return out


def mixed_candidates(pgm):
    from repro_torch.core.session import GridCandidate
    from repro_torch.index.adapters import DEFAULT_EPS_GRID

    size = pgm.size_model()
    return [GridCandidate(e, float(size(eps=e)), eps=e)
            for e in DEFAULT_EPS_GRID]


def compare_tunes(dev, host, tol_h):
    """Device vs host executor: same winner up to objective ties, per-cell
    hit rates within ``tol_h``."""
    worst = 0.0
    for name in ("pgm", "rmi", "multi"):
        a, b = dev[name], host[name]
        check(set(a.table) == set(b.table), f"{name}: knob sets differ")
        for kn, cells in a.table.items():
            for ca, cb in zip(cells, b.table[kn]):
                check(ca.capacity_pages == cb.capacity_pages,
                      f"{name} {kn}: capacities differ")
                worst = max(worst, abs(ca.hit_rate - cb.hit_rate))
        if (a.best, a.split) != (b.best, b.split):
            check(abs(a.objective_value - b.objective_value)
                  <= 1e-5 * abs(b.objective_value) + tol_h * max(
                      c.dac for cells in b.table.values() for c in cells),
                  f"{name}: device {a.best}/{a.split} vs host "
                  f"{b.best}/{b.split}")
    ga, gb = dev["mixed"], host["mixed"]
    for kn, est in gb.estimates.items():
        worst = max(worst, abs(est.hit_rate - ga.estimates[kn].hit_rate))
    check(worst <= tol_h, f"device vs host executor: max |dh| {worst:.3g}")
    return worst


def replay_check(world, pgm, rmi, results):
    from repro_torch.core.qerror import q_error
    from repro_torch.core.replay import replay_windows

    c_ipp = world["system"].geom.c_ipp
    out = {}
    for name, builder in (("pgm", pgm), ("rmi", rmi)):
        res = results[name]
        lo, hi = builder.build(res.best).window(world["qk"])
        misses = replay_windows(lo // c_ipp, hi // c_ipp, res.capacity_pages,
                                "lru")
        qe = float(q_error(res.est_io, float(misses.mean())))
        out[name] = dict(best=res.best, split=res.split,
                         capacity_pages=res.capacity_pages,
                         est_io=res.est_io, replay_io=float(misses.mean()),
                         q_error=qe)
        check(qe < Q_ERROR_BOUND, f"{name} replay q-error {qe:.3f} >= "
                                  f"{Q_ERROR_BOUND}")
    return out


def summarize(results):
    out = {}
    for name in ("pgm", "rmi", "multi"):
        r = results[name]
        out[name] = dict(best=r.best, split=r.split,
                         capacity_pages=r.capacity_pages, est_io=r.est_io,
                         knobs=len(r.table), skipped=len(r.skipped))
    g = results["mixed"]
    out["mixed"] = dict(best=g.best_knob, est_io=g.est_io,
                        knobs=len(g.estimates))
    return out


# ---------------------------------------------------------------------------
# Main
# ---------------------------------------------------------------------------

def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--keys", type=int, default=PAPER_KEYS // 10)
    ap.add_argument("--queries", type=int, default=1_000_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    src = ROOT / "src"
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script; run "
              "it from the root of a checkout", file=sys.stderr)
        return 1
    sys.path.insert(0, str(src))
    import numpy as np
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; the port's "
              "kernels need an NVIDIA GPU", file=sys.stderr)
        return 1
    on_card = args.device == "cuda"
    from repro_torch.kernels import _build
    from repro_torch.kernels import price_grid as tpg
    from repro_torch.kernels import profile_grid as tprof

    def sync():
        if on_card:
            torch.cuda.synchronize()

    t_start = time.perf_counter()
    smi = None
    # ---- 1. device and build ---------------------------------------------
    if on_card:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
        print(smi, flush=True)
        dev = torch.device("cuda")
        emit({"device": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count(), "torch": torch.__version__,
              "cuda": torch.version.cuda})
        _build.library()
        emit({"phase": "build", "seconds": _build.build_seconds,
              "built": ["price_grid", "profile_grid"],
              "sources": [str(s.relative_to(ROOT)) for s in _build.SOURCES]})

        # ---- 2. kernels vs plain versions, small shapes ------------------
        small = []
        for policy in ("lru", "fifo", "lfu", "multi"):
            for has_sorted in (False, True):
                for has_write in (False, True):
                    call, flags = synthetic_price(torch, policy, has_sorted,
                                                  has_write, dev)
                    small.append(compare_price(tpg, call, flags, 2e-6))
        prof_small = [
            compare_profile(tprof, synthetic_profile(
                torch, np, tprof, dev, 3, 4000, 61, 128, exact, seed), exact)
            for seed, exact in ((1, True), (2, False))]
        sync()
        emit({"phase": "kernels_small", "price_variants": len(small),
              "price_max_abs_err": max(small),
              "profile_max_abs_err": max(prof_small)})

    # ---- 3. the main path --------------------------------------------------
    world = build_world(args, args.device)
    pgm, rmi, t_sizes = size_model_builds(world)
    recorder = Recorder()
    undo = [recorder.install(tpg, tprof)]
    clock = PhaseClock(torch, sync)
    from repro_torch.core.session import CostSession
    from repro_torch.engine.table import PricingEngine
    undo.append(clock.wrap(CostSession, "_profile_batch", "profile"))
    undo.append(clock.wrap(PricingEngine, "price", "price"))
    tpg.launches = 0
    tprof.launches = 0
    t0 = time.perf_counter()
    results = run_main_path(world, pgm, rmi)
    sync()
    t_main = time.perf_counter() - t0
    launches = {"price_grid": tpg.launches, "profile_grid": tprof.launches}
    for u in reversed(undo):
        u()
    main_phases = dict(world["times"], size_model_builds=t_sizes,
                       profile=clock.seconds["profile"],
                       price=clock.seconds["price"], main_path=t_main)
    emit({"phase": "main_path", "keys": args.keys, "queries": args.queries,
          "budget_bytes": world["budget"], "seconds": main_phases,
          "launches": launches, "results": summarize(results)})
    if on_card:
        check(launches["price_grid"] > 0, "price_grid never launched on the "
                                          "main path")
        check(launches["profile_grid"] > 0, "profile_grid never launched on "
                                            "the main path")

    # ---- 4. kernels vs plain versions at the main path's shapes -----------
    kernels = []
    if on_card:
        kernels = main_shape_kernels(torch, np, tpg, tprof, dev, world, pgm,
                                     recorder, launches)

    # ---- 5. host executor on the same card, and trace replay --------------
    os.environ["REPRO_ENGINE_EXECUTOR"] = "host"
    try:
        t0 = time.perf_counter()
        host = run_main_path(world, pgm, rmi)
        sync()
        t_host = time.perf_counter() - t0
    finally:
        del os.environ["REPRO_ENGINE_EXECUTOR"]
    worst = compare_tunes(results, host, 1e-5)
    t0 = time.perf_counter()
    replay = replay_check(world, pgm, rmi, results)
    emit({"phase": "host_executor_and_replay", "host_seconds": t_host,
          "max_abs_dh_vs_host": worst, "replay": replay,
          "replay_seconds": time.perf_counter() - t0})
    check(np.isfinite([results[n].est_io for n in ("pgm", "rmi", "multi")]
                      ).all(), "non-finite estimates")

    if not on_card:
        print("chip_smoke: CPU rehearsal finished; no result without a GPU",
              file=sys.stderr)
        return 3
    emit({"total_seconds": time.perf_counter() - t_start})
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def main_shape_kernels(torch, np, tpg, tprof, dev, world, pgm, recorder,
                       launches):
    """Phase 4: every kernel variant at the main path's shapes, timed."""
    from repro_torch.core.cache_models import POLICIES as ALL_POLICIES
    from repro_torch.core.session import CostSession
    from repro_torch.engine.device import DeviceExecutor
    from repro_torch.engine.table import PriceTable, PricingEngine

    # price_grid: the recorded main path calls, plus every policy x
    # has_sorted x has_write variant over the mixed workload's profiles
    system = world["system"]
    prof = CostSession(system).grid_profiles(mixed_candidates(pgm),
                                             world["mixed"])
    variants = {}
    k = len(prof.knobs)
    for has_sorted in (False, True):
        for has_write in (False, True):
            pv = dataclasses.replace(
                prof, sparts=prof.sparts if has_sorted else (None,) * k,
                wparts=prof.wparts if has_write else ())
            base = PriceTable.from_profiles(
                pv, {kn: {} for kn in pv.knobs}, splits=(0.25, 0.5, 0.75),
                budget_bytes=system.memory_budget_bytes,
                page_bytes=system.geom.page_bytes)
            for policy in ALL_POLICIES + ("multi",):
                table = (base.cross_policies(ALL_POLICIES)
                         if policy == "multi" else base)
                sess = CostSession(dataclasses.replace(
                    system, policy="lru" if policy == "multi" else policy))
                grab = Recorder()
                undo = grab.install(tpg, tprof)
                try:
                    PricingEngine(sess).price(table,
                                              executor=DeviceExecutor())
                finally:
                    undo()
                variants.update(grab.price)
    price_err = 0.0
    detail = {}
    for key, (_, call, flags) in sorted(variants.items()):
        price_err = max(price_err, compare_price(tpg, call, flags, 1e-5))
    for key, (_, call, flags) in sorted(recorder.price.items()):
        err = compare_price(tpg, call, flags, 1e-5)
        price_err = max(price_err, err)
        nbytes, ops = price_work(call, flags)
        b_ms, b_by = bound(nbytes, ops)
        ms = cuda_ms(lambda: run_price(tpg.price_grid, call, flags))
        plain = cuda_ms(lambda: run_price(tpg.price_grid_ref, call, flags),
                        reps=3, warmup=1)
        detail["/".join(map(str, key))] = dict(
            shape=list(call["probs"].shape) + [call["caps_i"].shape[1]],
            ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
            max_abs_err=err, bytes=nbytes, ops=ops)
    emit({"phase": "kernels_main", "kernel": "price_grid",
          "variants_checked": len(variants) + len(recorder.price),
          "max_abs_err": price_err, "main_path_calls": detail})
    # the summary row: the main path call with the most (row, cell, page) work
    key = max(recorder.price, key=lambda kk: recorder.price[kk][0])
    head = detail["/".join(map(str, key))]
    price_row = dict(
        name="price_grid", route="cuda",
        source="src/repro_torch/kernels/csrc/price_grid.cu",
        replaces="src/repro/kernels/price_grid.py:274",
        launches=launches["price_grid"], max_abs_err=price_err,
        ms=head["ms"], plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
        bound_by=head["bound_by"], library_ms=None)

    # profile_grid: the recorded RMI branch-grid call, plus an integer-mass
    # grid of the same shape that must be exact
    _, call = recorder.profile
    err = compare_profile(tprof, call, exact=False)
    k_rows, q = call["keys"].shape
    num_pages = system.geom.num_pages(int(world["point"].n))
    exact_call = synthetic_profile(torch, np, tprof, dev, k_rows, q,
                                   num_pages, system.geom.c_ipp, True, 7)
    err_exact = compare_profile(tprof, exact_call, exact=True)
    nbytes, adds = profile_work(torch, call)
    b_ms, b_by = bound(nbytes, adds)
    ms = cuda_ms(lambda: run_profile(tprof.profile_grid, call))
    plain = cuda_ms(lambda: run_profile(tprof.profile_grid_ref, call),
                    reps=3, warmup=1)
    library = None
    if adds <= 2.5e9:
        tgt, vals = profile_entries(torch, call)
        out = torch.zeros(k_rows * call["pad"], dtype=torch.float32,
                          device=dev)
        library = cuda_ms(lambda: out.index_add_(0, tgt, vals))
        del tgt, vals, out
    emit({"phase": "kernels_main", "kernel": "profile_grid",
          "shape": [k_rows, q, call["pad"]], "lut": list(call["lut"].shape),
          "max_abs_err": err, "integer_mass_max_abs_err": err_exact,
          "adds": adds, "bytes": nbytes, "ms": ms, "plain_ms": plain,
          "bound_ms": b_ms, "bound_by": b_by, "library_ms": library})
    profile_row = dict(
        name="profile_grid", route="cuda",
        source="src/repro_torch/kernels/csrc/profile_grid.cu",
        replaces="src/repro/kernels/profile_grid.py:134",
        launches=launches["profile_grid"], max_abs_err=max(err, err_exact),
        ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
        library_ms=library)
    return [price_row, profile_row]


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
