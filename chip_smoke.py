#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) through CAM's main path,
CAM's join layer, CAM's online layers (serving sketch, sharded fleet, write
path), the LM serving path of every model family, LM training and the
multi-device training path on one NVIDIA GPU, and hold its six CUDA
kernels against their plain versions.

Run from the root of a checkout::

    python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero and never
prints its last line):

1. device and build — ``nvidia-smi`` name and power limit, the kernels
   built from ``src/repro_torch/kernels/csrc`` with ``nvcc``;
2. kernels vs plain versions at small shapes, every variant (attention:
   causal and not, float32 and bfloat16, GQA 1:1 to 8:1, ragged lengths,
   head_dim 64 and 128; Che sums at N in {1, 1000, 100,003}, K in {1, 8};
   the fused Che solve at the same N);
3. the main path at the paper's §VII-A setup with one cut (20M books keys
   instead of 200M): 1M w4 point queries, 4 KiB pages, 256 keys per page,
   a 12.8 MiB budget (the paper's 128 MiB scaled by the same 1/10), LRU —
   ``TuningSession.tune`` for PGM and RMI, a multi-policy tune, and
   ``CostSession.estimate_grid`` on a mixed workload (points + a sorted
   range stream + updates); then the Che path: ``hit_rate_lru(
   use_kernel=True)`` on every (row, capacity) of the PGM tune's profile
   (78,125 pages): one fused ``che_solve`` launch a solve and no
   ``che_sums`` launch, h held to the bisection path (1e-4) and T to the
   plain host loop on the same card tensors (1e-4 relative); the same
   solves through the earlier host loop of ``che_sums`` launches are timed
   beside it.  Launch counters are zeroed just before each path and read
   just after;
4. kernels vs plain versions at the main path's shapes (every variant),
   with CUDA-event times, the plain version's time, the card's lower bound
   and, where one PyTorch call computes the same function, its time;
   ``price_grid`` also reports the bisection steps its cells ran, an
   ex2-count reading beside its bound and, for the multi-policy call,
   each policy's rows timed alone; ``profile_grid`` its page sort's
   and its kernel's times (``ms`` is their sum) and its global flushes;
   ``che_solve`` the earlier host loop's times and a bit-equality check
   of two calls (``che_sums`` checks its bits the same way);
5. the main path again through the host executor on the same card, and a
   trace replay of the chosen PGM and RMI configurations (q-error < 1.4);
5b. the join path at the paper's §VII-A join setup with the same 1/10
   cut (``repro_torch.configs.cam_paper.PAPER``): the 20M keys in a PGM at
   eps 64, 100,000 w4 outer probes, a 1.6 MiB LRU buffer on top of the
   index.  ``JoinSession.calibrate`` (the fitted Eq. 17 coefficients beside
   the paper's Table III, printed only: the machine is simulated),
   ``choose`` and a replay of all four strategies (the choice within 1.10x
   of the best replayed seconds, every strategy's predicted I/O within
   q-error 2.0 of its replay, the INLJ/hybrid ratio recorded),
   ``cost_curve`` at 8 capacities (non-increasing), and a three-level LFU
   ``JoinTreeSession`` planned and replayed.  Every ``price_grid`` call of
   the path is held to its plain version (1e-5) and every priced table to
   the host executor (1e-5 on h); on the card the path must launch
   ``price_grid`` and price through nothing else;
5c. the online layers, each through ``price_grid`` alone (counters zeroed
   just before each path and read just after; every engine call priced by
   the device executor; every ``price_grid`` call held to its plain
   version at 1e-5; each path rerun through the host executor on the same
   card, with identical decisions, every priced cell's h within 1e-5 and
   its I/O within rtol 1e-5 or 2e-6 E[DAC]):
   ``serving`` — the drift benchmark's full configuration
   (``repro_torch.launch.bench_serving_drift``: 400,000 books keys, a 512
   KiB LRU buffer, eps 8..512, 63,488 events), all four arms, the
   rebuild gate held and every arm's I/O and rebuilds held to the JAX
   reference's run of the same benchmark (rtol 1e-5; the reference's own
   1.2x gate fails at this size and is recorded); then the adaptive arm
   on the main path's 20M keys and 12.8 MiB budget under the same drift
   script (23 streamed batches of 2,048 after 8 warmup batches), timed
   per batch, its static/adaptive ratio recorded and not gated;
   ``sharding`` — ``bench_sharding``'s full configuration (200,000 keys,
   100,000 point queries, 4 shards of 160 KiB, a 150-page hot slab) under
   lru, fifo and lfu, the 1.15x gate per policy; ``write`` —
   ``bench_write_path``'s full configuration (400,000 keys, 34,000
   events, 640 buffer pages), three schedulers, their gates and one engine
   call per decision event, then the ALEX and B+-tree tunes on a
   read/write mix over its keys (the caller that prices write streams).
   ``price_grid`` is timed at each path's largest table and at the write
   path's most frequent one;
6. the serving path: yi-34b at full width and depth (bf16 weights from a
   seeded generator, all 60 layers), batch 4, a 1,024-token prompt, 32
   greedy tokens under ``Recipe(attn_impl="pallas")`` — prefill through
   ``flash_attention`` once a layer, every decode step through
   ``decode_attention`` once a layer.  A second, identical generate holds
   every one of those calls against the plain version on the layer's own
   inputs (within one bfloat16 ulp of the call's largest output), so
   kernel error is judged apart from what sixty bf16 layers make of it.
   End to end the path is held against the same engine under
   ``attn_impl="blockwise"``: prefill logits within 2e-2 of their
   max-abs, and the first generated token equal up to ties (where the
   tokens differ, the plain path's logits of the two may lie no further
   apart than the plain path moves its own logits under 512-key blocks).
   Then the CAM KV-pool plan line of ``repro_torch.launch.serve``; the
   attention kernels are timed at the shapes this run gave them, with
   their achieved TFLOP/s (flash) and GB/s (decode);
7. the other families, after yi-34b's weights are freed, each at full
   width and depth with phase 6's run and gates (one ``families`` line
   each).  The logits gate is 2e-2 or, where the plain path's own spread
   under 512-key blocks is larger than half of that, twice that spread; a
   MoE model's plain runs replay the counted run's prefill routing (see
   ``RouteShare``).  The attention counters are the counted generate's;
   the four CAM kernels' are zeroed before each family and held to 0.
   Configs: qwen2-moe-a2.7b (60 + 4 experts, top-4), qwen2-vl-7b (M-RoPE;
   also ``prefill_fn`` with ``vision_embeds`` and ``positions_3d`` as
   ``input_specs`` shapes them, which the engine never passes),
   musicgen-medium (4 codebooks), rwkv6-3b (no attention) and zamba2-2.7b
   (54 Mamba2 layers, the shared attention block at head_dim 80 after
   every 6).  For rwkv6 and zamba2 the chunked prefill is held to the
   stepwise decode recurrence on a 256-token prompt in float32: last
   logits within 2e-2, the first layer's (group's) states within 1e-3,
   every layer's recorded.  phi3.5-moe (~83.7 GB of bf16 weights) does not
   fit one card.  The attention kernels are then timed at zamba2's
   head_dim-80 shapes;
8. training, after the families' weights are freed: starcoder2-3b at full
   width and depth (float32 masters from a seeded generator, bf16 compute,
   ``Recipe(remat="block", microbatch=1, attn_impl="blockwise")``, float32
   AdamW moments, lr 3e-4 with 5 warmup steps), 8 steps of 4 x 1,024
   tokens from ``TokenPipeline`` through
   ``repro_torch.launch.train.build_trainer``; one ``train`` line with
   seconds a step, tokens/s, ``mfu`` (6·N·tokens over step seconds × 989
   TFLOP/s), peak memory, every loss and grad norm, the six kernel
   counters (zeroed before the phase; no kernel has a backward, so all
   must read 0), a step with the AdamW update timed apart and a profiled
   step.  Gates: finite losses and norms, the last loss below the first,
   step 0 against a float32 compute copy of the same masters on the same
   batch (loss within 2e-2, grad norm within 5e-2 relative), and
   ``attention(impl="pallas")`` refusing inputs that require grad.  Then
   the Supervisor leg: ``repro_torch.launch.train_lm`` at its full
   configuration (8 x 512, 60 steps of 8 x 128 tokens, checkpoints every
   25) uninterrupted and with a failure injected at step 30: one restart,
   final step 60, the loss decreasing, both last losses within 1e-6;
9. the distributed path, after phase 8's state is freed, on a one-rank
   NCCL process group (a file store): phase 8's model, masters, recipe
   and batches through ``repro_torch.launch.cells.build_cell`` on a
   (data 1, model 1) ``DeviceMesh`` (DTensor params), 3 steps against 3
   mesh-less steps (losses and grad norms within 1e-5), seconds a step,
   peak and a profiled step; the pod-compressed step
   (``compress_pod_grads`` on (pod 1, data 1, model 1)) at full depth, 3
   steps, its compression timed apart (its share from step 1 on) and step
   0's int8 error within scale/2 + 1e-6 on every leaf; train_lm's
   Supervisor leg on the mesh (one restart, last losses within 1e-6);
   ``launch.dryrun.run_cell`` in subprocesses, on the CPU beside the
   Supervisor leg: step 1's cell on a fake one-rank world (its peak
   beside the measured one) and the two
   production cells (starcoder2-3b ``decode_32k``, qwen2-moe-a2.7b
   ``train_4k``) on the fake 256-rank (32, 8) mesh; the analytic H100
   bound of step 1's cell and the whole H100 roofline table (a
   ``distributed`` and a ``distributed_roofline_h100`` line).  No kernel
   launches (all six counters 0).

Kernel times are device times: CUDA events around calls queued behind a
spin kernel, so the host's launch rate does not enter.  Every kernel row
also gives ``call_ms``, the wall time of back-to-back calls with the host
included: what a caller pays where launches, not the device, set the pace.

The line before the last is the per-kernel JSON summary; the last line is
``{"ok": true, "device": {...}}``.  ``--device cpu`` rehearses phases 3,
5, 5b, 5c, 6, 7, 8 and 9 (a gloo world, no dry runs) on the CPU (6 to 8 on ``reduced`` configs, 8 at 4 x
128 tokens with train_lm's ``--smoke`` as its Supervisor leg, whose loss
is recorded, not gated; the join's outer
stream, buffer and tree scaled from ``--keys`` by the same ratios; 5c at
the benchmarks' ``--smoke`` sizes, its scale leg on ``--keys``) at a
smaller ``--keys``/``--queries`` and exits non-zero without a result.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import io
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
F32_FLOPS_PER_S = 67e12          # H100 SXM float32, outside the tensor cores
BF16_FLOPS_PER_S = 989e12        # H100 SXM bf16 tensor cores, dense
# MUFU ex2 issue rate of an H100 SXM: 16 a clock on each of 132 SMs at the
# 1.98 GHz boost clock (a reading beside price_grid's bound, not the bound)
EX2_PER_S = 132 * 16 * 1.98e9
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

SPIN_CYCLES_PER_S = 2.0e9       # above the H100's 1.98 GHz boost clock


def cuda_times(fn, reps: int = 10, warmup: int = 2):
    """(device ms, wall ms) per call of ``fn``.  Wall: ``reps`` calls back
    to back, host clock to a synchronize — what a caller pays, host
    overhead included.  Device: CUDA events around ``reps`` calls queued
    behind a spin kernel (``torch.cuda._sleep``) that keeps the device
    busy until the host has queued them all, so the events time the
    device's work and not the host's launch rate."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(2.0 * wall, 1.0) * SPIN_CYCLES_PER_S))
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps, 1e3 * wall / reps


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    return cuda_times(fn, reps, warmup)[0]


def bound(nbytes: float, ops: float, ops_per_s: float = F32_FLOPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
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


def price_steps(tpg, call, flags):
    """The kernel's own reading of one call: bisection steps each cell ran
    ((K, C) int32; 0 where a cell does not bisect)."""
    import torch
    steps = torch.zeros_like(call["caps_i"])
    tpg.price_grid(call["policy"], *(call[n] for n in PRICE_ARGS), **flags,
                   steps=steps)
    return steps


def price_ex2(call, flags, steps):
    """expm1f evaluations the call's LRU cells need at the steps they ran
    (each step and the final pass over P pages, plus the writeback's), one
    MUFU ex2 each: a count for the ex2 reading, not the bound."""
    import numpy as np
    k, p = call["probs"].shape
    modes = {"lru": 0, "fifo": 1, "lfu": 2}
    pol = (call["i32s"][:, 3].cpu().numpy() if call["policy"] == "multi"
           else np.full(k, modes[call["policy"]]))
    st = steps.cpu().numpy().astype(np.int64)
    lru = (pol[:, None] == 0) & (st > 0)
    per_cell = (st + 1 + (1 if flags["has_write"] else 0)) * p
    return float(per_cell[lru].sum())


def price_policy_ms(tpg, call, flags):
    """Device ms of a multi-policy call's rows of each policy alone: where
    its time goes when the card is full with either policy's rows."""
    import torch
    out = {}
    for name, pid in (("lru", 0), ("fifo", 1), ("lfu", 2)):
        rows = torch.nonzero(call["i32s"][:, 3] == pid).flatten()
        if rows.numel():
            part = {n: v.index_select(0, rows).contiguous()
                    if torch.is_tensor(v) else v for n, v in call.items()}
            out[name] = cuda_ms(lambda: run_price(tpg.price_grid, part,
                                                  flags))
    return out


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
    the shapes phase 4 holds each kernel to — and, with ``keep_all``,
    every ``price_grid`` call in order."""

    def __init__(self, keep_all: bool = False):
        self.price = {}
        self.profile = None
        self.price_calls = [] if keep_all else None

    def install(self, tpg, tprof):
        real_price, real_profile = tpg.price_grid, tprof.profile_grid

        def price(*a, **kw):
            call, flags = price_call(a, kw)
            key = (call["policy"], bool(flags["has_sorted"]),
                   bool(flags["has_write"]))
            size = call["probs"].numel() * call["caps_i"].shape[1]
            if key not in self.price or size > self.price[key][0]:
                self.price[key] = (size, call, flags)
            if self.price_calls is not None:
                self.price_calls.append((call, flags))
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
    from repro_torch.configs.cam_paper import PAPER
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
    budget = PAPER.buffer_bytes * args.keys / PAPER.keys_per_dataset
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
# Attention and Che kernels: small checks, work counts, library calls
# ---------------------------------------------------------------------------

ATTN_TOL = {"float32": 1e-4, "bfloat16": 2e-2}   # tests/test_kernels.py
# At the serve path's shapes kernel and plain version both accumulate in
# float32 and round once to bfloat16, so they may differ by one bf16 ulp
# of an output, at most 2**-7 of the call's largest output.
ATTN_ULP_REL = 2.0 ** -7
LOGITS_TOL = 2e-2    # serve path vs its plain path, relative to max-abs
CHE_RTOL, CHE_ATOL = 1e-4, 1e-3
CHE_T_RTOL = 1e-4    # T of che_solve, relative (the CPU parity bound vs JAX)
CHE_K, CHE_ITERS = 8, 16     # hit_rate_lru(use_kernel=True)
SERVE_BATCH = 4


def _normal(torch, np, rng, shape, dtype, dev):
    return torch.as_tensor(rng.standard_normal(shape).astype(np.float32),
                           device=dev).to(dtype)


def _dtype_name(torch, dtype):
    return "bfloat16" if dtype == torch.bfloat16 else "float32"


def compare_attention(torch, name, out, ref, dtype):
    """Max |out - ref|, held to the JAX package's tolerance (atol + rtol)."""
    tol = ATTN_TOL[_dtype_name(torch, dtype)]
    diff = (out.float() - ref.float()).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    check(bool((diff <= tol + tol * ref.float().abs()).all()),
          f"{name} {dtype}: max |d| {err:.3g} over tolerance {tol:g}")
    return err


def ulp_stats(torch, out, ref):
    """(max |out - ref|, max |ref|, mean |ref|) as one device tensor."""
    r = ref.float().abs()
    return torch.stack([(out.float() - ref.float()).abs().max(), r.max(),
                        r.mean()])


def hold_ulp(name, stats):
    """Held to ``ATTN_ULP_REL`` of the largest output; returns the numbers
    the kernels_main line prints."""
    err, ref_max, ref_mean = (float(x) for x in stats)
    check(err <= ATTN_ULP_REL * ref_max,
          f"{name}: max |d| {err:.3g} > 2**-7 x max |ref| {ref_max:.3g}")
    return dict(max_abs_err=err, max_abs_ref=ref_max, mean_abs_ref=ref_mean,
                max_err_over_max_ref=err / ref_max if ref_max else 0.0)


def small_attention_checks(torch, np, tfa, tda, tche, dev):
    rng = np.random.default_rng(0)
    flash, decode, che, solve = [], [], [], []
    # (B, S, H, Hk, D): GQA 1:1, 2:1, 7:1 and 8:1, S ragged against the
    # kernel's 64-row tiles, D 64 and 128
    for b, s, h, hk, d in ((1, 64, 4, 4, 64), (2, 200, 8, 4, 64),
                           (1, 300, 14, 2, 128), (2, 97, 8, 1, 128)):
        for dtype in (torch.float32, torch.bfloat16):
            for causal in (True, False):
                q = _normal(torch, np, rng, (b, s, h, d), dtype, dev)
                k = _normal(torch, np, rng, (b, s, hk, d), dtype, dev)
                v = _normal(torch, np, rng, (b, s, hk, d), dtype, dev)
                flash.append(compare_attention(
                    torch, "flash_attention",
                    tfa.flash_attention(q, k, v, causal=causal),
                    tfa.flash_attention_ref(q, k, v, causal=causal), dtype))
    for b, s, h, hk, d in ((3, 130, 8, 8, 64), (4, 1064, 56, 8, 128),
                           (2, 515, 16, 2, 128)):
        for dtype in (torch.float32, torch.bfloat16):
            q = _normal(torch, np, rng, (b, 1, h, d), dtype, dev)
            kc = _normal(torch, np, rng, (b, s, hk, d), dtype, dev)
            vc = _normal(torch, np, rng, (b, s, hk, d), dtype, dev)
            lens = torch.as_tensor(rng.integers(1, s + 1, b), dtype=torch.int32,
                                   device=dev)
            lens[0] = 0                     # the -1e30 fill: mean of V
            decode.append(compare_attention(
                torch, "decode_attention",
                tda.decode_attention(q, kc, vc, lens),
                tda.decode_attention_ref(q, kc, vc, lens), dtype))
    for n in (1, 1000, 100_003):
        for k in (1, 8):
            p = rng.zipf(1.3, n).astype(np.float64)
            probs = torch.as_tensor((p / p.sum()).astype(np.float32),
                                    device=dev)
            ts = torch.as_tensor(np.logspace(0, 6, k).astype(np.float32),
                                 device=dev)
            out, ref = tche.che_sums(probs, ts), tche.che_sums_ref(probs, ts)
            err = float((out - ref).abs().max())
            check(bool(((out - ref).abs() <= CHE_ATOL + CHE_RTOL * ref.abs())
                       .all()), f"che_sums N={n} K={k}: max |d| {err:.3g}")
            che.append(err)
        cap = max(0.3 * float((probs > 0).sum()), 0.5)
        t_k, t_r = tche.che_solve(probs, cap), tche.che_solve_ref(probs, cap)
        rel = abs(float(t_k) - float(t_r)) / abs(float(t_r))
        check(rel <= CHE_T_RTOL, f"che_solve N={n}: T relative error "
                                 f"{rel:.3g} > {CHE_T_RTOL:g}")
        solve.append(rel)
    return dict(flash_cases=len(flash), flash_max_abs_err=max(flash),
                decode_cases=len(decode), decode_max_abs_err=max(decode),
                che_cases=len(che), che_max_abs_err=max(che),
                che_solve_cases=len(solve), che_solve_max_rel_err=max(solve))


def flash_work(q, k, causal: bool):
    """(bytes, bf16/f32 operations) of one flash call: q, k, v read once,
    out written once; 4·D operations per (query, key) pair the mask keeps."""
    b, sq, h, d = q.shape
    skv, hk = k.shape[1], k.shape[2]
    nbytes = (2 * b * sq * h * d + 2 * b * skv * hk * d) * q.element_size()
    pairs = sq * (sq + 1) // 2 if causal else sq * skv
    return float(nbytes), float(4 * b * h * d * pairs)


def decode_work(q, kc, lengths):
    """(bytes, operations) of one decode call: q, the valid cache rows of
    every sequence, lengths and out each once; 4·D operations per (query
    head, valid position)."""
    b, _, h, d = q.shape
    s, hk = kc.shape[1], kc.shape[2]
    valid = float(lengths.clamp(0, s).sum())
    nbytes = (2 * b * h * d * q.element_size()
              + 2 * valid * hk * d * kc.element_size() + 4 * b)
    return float(nbytes), 4.0 * h * d * valid


def sdpa_flash(torch, q, k, v, causal):
    """The one PyTorch call computing flash_attention's function."""
    return torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        is_causal=causal, enable_gqa=True)


def sdpa_decode(torch, q, kc, vc, lengths):
    """The one PyTorch call computing decode_attention's function (for
    lengths >= 1: a boolean mask of the valid positions)."""
    mask = (torch.arange(kc.shape[1], device=kc.device)[None]
            < lengths[:, None])[:, None, None]
    return torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2),
        attn_mask=mask, enable_gqa=True)


# ---------------------------------------------------------------------------
# The Che path: hit_rate_lru(use_kernel=True) on the PGM profile
# ---------------------------------------------------------------------------

def che_solve_host_loop(torch, tche, probs, capacity, k=CHE_K,
                        iters=CHE_ITERS):
    """(T, h) of the Che solve as it ran before the fused kernel, for
    timing: the plain host loop (``ref.che_solve_ref``) with each pass's
    sums from one ``che_sums`` launch."""
    from repro_torch.kernels import ref
    plain = ref.che_sums_ref
    ref.che_sums_ref = tche.che_sums
    try:
        t = ref.che_solve_ref(probs, capacity, k=k, iters=iters)
    finally:
        ref.che_sums_ref = plain
    return t, torch.sum(probs * -torch.expm1(-probs * t))


def che_path(torch, tcm, tche, recorder):
    """Every (row, capacity) of the main path's PGM tune, through the
    fused Che solve and through bisection; launch counters zeroed just
    before and read just after.  T is held to the plain host loop on the
    same tensors, and the same solves run once more through the earlier
    host loop of ``che_sums`` launches, timed alone."""
    _, call, _ = recorder.price[("lru", False, False)]
    probs, caps = call["probs"], call["caps_i"].cpu().tolist()
    nd = call["i32s"][:, 0].cpu().tolist()
    work = [(r, c) for r in range(probs.shape[0]) for c in caps[r]
            if 1 <= c < nd[r]]
    t0 = time.perf_counter()
    tche.launches = 0
    tche.solve_launches = 0
    h_kernel = [tcm.hit_rate_lru(probs[r], c, use_kernel=True)
                for r, c in work]
    solve_launches, sums_launches = tche.solve_launches, tche.launches
    h_kernel = torch.stack(h_kernel).cpu()
    seconds = time.perf_counter() - t0
    t0 = time.perf_counter()
    h_loop = torch.stack([che_solve_host_loop(torch, tche, probs[r], c)[1]
                          for r, c in work]).cpu()
    loop_seconds = time.perf_counter() - t0
    h_bisect = torch.stack([tcm.hit_rate_lru(probs[r], c)
                            for r, c in work]).cpu()
    err = float((h_kernel - h_bisect).abs().max())
    check(err <= 1e-4, f"Che path: |h kernel - h bisection| {err:.3g} > 1e-4")
    t_kernel = torch.stack([tche.che_solve(probs[r], c, k=CHE_K,
                                           iters=CHE_ITERS)
                            for r, c in work]).cpu()
    t_plain = torch.stack([tche.che_solve_ref(probs[r], c, k=CHE_K,
                                              iters=CHE_ITERS)
                           for r, c in work]).cpu()
    t_rel = float(((t_kernel - t_plain).abs() / t_plain.abs()).max())
    check(t_rel <= CHE_T_RTOL, f"Che path: T relative to the plain loop "
                               f"{t_rel:.3g} > {CHE_T_RTOL:g}")
    # timing operands: the largest row, one pass's 8 candidates, and the
    # median capacity solved on that row
    big = max(range(probs.shape[0]), key=lambda r: nd[r])
    row = probs[big].contiguous()
    row_caps = sorted(c for r, c in work if r == big)
    ts = torch.logspace(0, 6, 8, device=row.device)
    return dict(solves=len(work), pages=probs.shape[1],
                solve_launches=solve_launches, che_sums_launches=sums_launches,
                seconds=seconds, host_loop_seconds=loop_seconds,
                max_abs_dh_vs_bisection=err,
                max_abs_dh_vs_host_loop=float((h_kernel - h_loop).abs().max()),
                max_rel_dt_vs_plain=t_rel,
                h_range=[float(h_kernel.min()), float(h_kernel.max())]), \
        (row, ts, row_caps[len(row_caps) // 2] if row_caps else 1)


def che_row(torch, tche, operands, launches):
    row, ts, _ = operands
    out, ref = tche.che_sums(row, ts), tche.che_sums_ref(row, ts)
    err = float((out - ref).abs().max())
    check(bool(((out - ref).abs() <= CHE_ATOL + CHE_RTOL * ref.abs()).all()),
          f"che_sums at the main path's shape: max |d| {err:.3g}")
    check(torch.equal(out, tche.che_sums(row, ts)),
          "che_sums: two calls on the same inputs differ")
    n, k = row.shape[0], ts.shape[0]
    b_ms, b_by = bound(4.0 * (n + 2 * k), 3.0 * n * k)
    ms, call_ms = cuda_times(lambda: tche.che_sums(row, ts), reps=50)
    plain = cuda_ms(lambda: tche.che_sums_ref(row, ts), reps=50)
    emit({"phase": "kernels_main", "kernel": "che_sums", "shape": [n, k],
          "max_abs_err": err, "ms": ms, "call_ms": call_ms, "plain_ms": plain,
          "bound_ms": b_ms, "bound_by": b_by})
    return dict(name="che_sums", route="cuda",
                source="src/repro_torch/kernels/csrc/che_sums.cu",
                replaces="src/repro/kernels/che_solver.py:65",
                launches=launches, max_abs_err=err, ms=ms, call_ms=call_ms,
                plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=None)


def che_solve_row(torch, tche, operands, launches):
    """The fused solve at the Che path's largest row: T against the plain
    loop, h against h summed from its own T, two calls bit-equal; device
    and call times beside the plain loop's and the earlier host loop's."""
    row, _, cap = operands
    k, iters = CHE_K, CHE_ITERS
    t_k, h_k = tche.che_hit_rate(row, cap, k=k, iters=iters)
    t_2, h_2 = tche.che_hit_rate(row, cap, k=k, iters=iters)
    check(torch.equal(t_k, t_2) and torch.equal(h_k, h_2),
          "che_solve: two calls on the same inputs differ")
    t_ref = float(tche.che_solve_ref(row, cap, k=k, iters=iters))
    err = abs(float(t_k) - t_ref)
    check(err <= CHE_T_RTOL * abs(t_ref), f"che_solve at the main path's "
          f"shape: T {float(t_k)!r} vs plain {t_ref!r}")
    h_own = float(torch.sum(row * -torch.expm1(-row * t_k)))
    check(abs(float(h_k) - h_own) <= 2e-6 * h_own,
          f"che_solve: h {float(h_k)!r} vs h from its T {h_own!r}")
    n = row.shape[0]
    b_ms, b_by = bound(4.0 * n + 8.0, 3.0 * n * k * iters + 3.0 * n)
    ms, call_ms = cuda_times(
        lambda: tche.che_hit_rate(row, cap, k=k, iters=iters), reps=50)
    plain = cuda_ms(lambda: tche.che_solve_ref(row, cap, k=k, iters=iters),
                    reps=20)
    loop_ms, loop_call_ms = cuda_times(
        lambda: che_solve_host_loop(torch, tche, row, cap, k, iters), reps=20)
    # where the time goes: the same launch with no pass (staging, the min,
    # the hit rate), and with every pass on a one-page input (barriers and
    # reductions with next to no work)
    no_pass_ms = cuda_ms(lambda: tche.che_hit_rate(row, cap, k=k, iters=0),
                         reps=50)
    one_page_ms = cuda_ms(
        lambda: tche.che_hit_rate(row[:1], 0.5, k=k, iters=iters), reps=50)
    plan = tche.solve_plan(n, tche._grids[row.device.index])
    emit({"phase": "kernels_main", "kernel": "che_solve",
          "shape": [n, k, iters], "grid": [plan.blocks, plan.threads],
          "spilled": plan.spilled, "capacity": cap, "t": float(t_k),
          "t_plain": t_ref, "max_abs_err": err, "bit_equal_calls": True,
          "ms": ms, "call_ms": call_ms, "plain_ms": plain,
          "host_loop_ms": loop_ms, "host_loop_call_ms": loop_call_ms,
          "no_pass_ms": no_pass_ms, "one_page_ms": one_page_ms,
          "bound_ms": b_ms, "bound_by": b_by})
    return dict(name="che_solve", route="cuda",
                source="src/repro_torch/kernels/csrc/che_solve.cu",
                replaces="src/repro/kernels/che_solver.py:82",
                launches=launches, max_abs_err=err, ms=ms, call_ms=call_ms,
                plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=None)


# ---------------------------------------------------------------------------
# The serving path: yi-34b at full width
# ---------------------------------------------------------------------------

class AttentionCheck:
    """Wraps the flash and decode entry points of ``kernels.ops`` for one
    generate: every call's kernel output is held against the plain version
    on the same inputs, and the first call of each is kept (the decode
    caches cloned: the live ones are rewritten in place) for timing at the
    serve path's shapes."""

    NAMES = ("flash_attention", "decode_attention")

    def __init__(self, torch, tfa, tda):
        self.torch = torch
        self.plain = {"flash_attention": tfa.flash_attention_ref,
                      "decode_attention": tda.decode_attention_ref}
        self.first = {}
        self.stats = {n: [] for n in self.NAMES}

    def install(self, tops):
        real_f, real_d = tops.flash_attention, tops.decode_attention

        def flash(q, k, v, *, causal=True):
            out = real_f(q, k, v, causal=causal)
            self.first.setdefault("flash_attention", (q, k, v, causal))
            self.stats["flash_attention"].append(ulp_stats(
                self.torch, out, self.plain["flash_attention"](
                    q, k, v, causal=causal)))
            return out

        def decode(q, kc, vc, lengths):
            out = real_d(q, kc, vc, lengths)
            if "decode_attention" not in self.first:
                self.first["decode_attention"] = (
                    q.clone(), kc.clone(), vc.clone(), lengths.clone())
            self.stats["decode_attention"].append(ulp_stats(
                self.torch, out, self.plain["decode_attention"](
                    q, kc, vc, lengths)))
            return out

        tops.flash_attention, tops.decode_attention = flash, decode
        return lambda: (setattr(tops, "flash_attention", real_f),
                        setattr(tops, "decode_attention", real_d))

    def summary(self):
        """Per kernel: calls, the worst call's error over its largest
        output, and the spread of the outputs' sizes."""
        out = {}
        for name in self.NAMES:
            if not self.stats[name]:
                out[name] = dict(calls=0)
                continue
            st = self.torch.stack(self.stats[name]).cpu().double()
            rel = st[:, 0] / st[:, 1].clamp(min=1e-30)
            worst = int(rel.argmax())
            out[name] = dict(
                calls=st.shape[0], max_err_over_max_ref=float(rel[worst]),
                worst_call=worst, max_abs_err=float(st[:, 0].max()),
                max_abs_ref_range=[float(st[:, 1].min()),
                                   float(st[:, 1].max())],
                mean_abs_ref_range=[float(st[:, 2].min()),
                                    float(st[:, 2].max())])
        return out


class RouteShare:
    """A MoE model's routing is discontinuous: a rounding difference can
    move a token's top-k, and through the capacity's slot order the drops
    of later tokens, so two float32 summation orders of the same bf16 path
    already differ by O(1) in a few tokens (qwen2-moe's plain path against
    itself under 512-key blocks: 6.6e-2 of its max-abs logit).  To hold the
    kernels' path to the plain one at the dense families' tolerance, the
    top-k experts of each prefill routing call are recorded in the counted
    run and replayed in the plain runs (gates from the replaying run's own
    router probabilities, slots and drops recomputed); the free runs are
    reported beside them with the count of tokens whose experts differ."""

    def __init__(self, calls: int):
        from repro_torch.models import moe
        self.moe, self.calls, self.idx = moe, calls, []

    @contextlib.contextmanager
    def _patched(self, fn):
        real = self.moe.route
        self.moe.route = lambda *a: fn(real, *a)
        try:
            yield
        finally:
            self.moe.route = real

    def recording(self, into):
        def rec(real, *a):
            r = real(*a)
            if len(into) < self.calls:
                into.append(r.idx)
            return r
        return self._patched(rec)

    def replaying(self):
        left = list(self.idx)

        def rep(real, xf, router_w, top_k, e_pad, cf):
            r = real(xf, router_w, top_k, e_pad, cf)
            return self.moe.routing(r.probs, left.pop(0), e_pad, cf) \
                if left else r
        return self._patched(rep)

    def differing_tokens(self, other) -> int:
        """(token, layer) pairs whose expert set differs from the record."""
        return int(sum(int((a.sort(-1).values != b.sort(-1).values)
                           .any(-1).sum()) for a, b in zip(self.idx, other)))


def _rel(a, b) -> float:
    """max |a - b| over max |b|."""
    b = b.float()
    return float((a.float() - b).abs().max() / b.abs().max().clamp(min=1e-30))


def attention_layers(cfg) -> int:
    """Attention calls of one forward: every layer of a transformer, the
    shared block once a group in the hybrid, none in RWKV."""
    if cfg.family == "rwkv":
        return 0
    if cfg.family == "hybrid":
        return cfg.num_layers // cfg.shared_attn_every
    return cfg.num_layers


def family_prompts(np, cfg, rng, batch, n):
    shape = (batch, n) + ((cfg.num_codebooks,) if cfg.family == "audio"
                          else ())
    return rng.integers(0, cfg.vocab_size, shape).astype(np.int32)


def serve_model(args, torch, np, dev, on_card, tfa, tda, tops, cfg, phase,
                spread_gate: bool = False):
    """One model served at ``cfg``'s size: bf16 seeded weights, batch 4,
    ``--prompt-len`` tokens, ``--new-tokens`` greedy steps under
    ``Recipe(attn_impl="pallas")``, the flash and decode counters zeroed
    just before the counted generate and read just after.  A second,
    identical generate holds every attention call against the plain
    version on the call's own inputs; the blockwise engine is the plain
    path end to end, held to ``LOGITS_TOL`` or, with ``spread_gate``, to
    twice the plain path's own spread under 512-key blocks where that is
    larger: if the kernels' path is one more float32 summation order of
    the same bf16 model, it lies within the spread of the 512-key run and
    that run within the spread of the plain one, so the two spreads bound
    it (the triangle inequality).  Returns the line's numbers, the checks
    (run by the caller after it prints the line), the first call of each
    kernel, the launches, the pallas engine, its prompts and the
    weights."""
    from repro_torch.distributed.sharding import Recipe
    from repro_torch.models.params import init_params
    from repro_torch.serve.engine import ServeEngine

    batch, prompt_len, new = SERVE_BATCH, args.prompt_len, args.new_tokens
    out = {"phase": phase, "arch": cfg.name, "family": cfg.family,
           "layers": cfg.num_layers, "d_model": cfg.d_model,
           "heads": [cfg.num_heads, cfg.num_kv_heads],
           "head_dim": cfg.head_dim, "d_ff": cfg.d_ff,
           "vocab": cfg.vocab_size, "batch": batch, "prompt": prompt_len,
           "new_tokens": new}
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = init_params(cfg, gen, dtype=torch.bfloat16, device=dev)
    if on_card:
        torch.cuda.synchronize()
    out["init_seconds"] = time.perf_counter() - t0
    out["param_bytes"] = sum(t.numel() * t.element_size()
                             for t in _leaves(params))
    prompts = family_prompts(np, cfg, np.random.default_rng(args.seed),
                             batch, prompt_len)
    max_seq = prompt_len + new + 8
    engines = {impl: ServeEngine(cfg, params, recipe=Recipe(
        remat="none", attn_impl=impl), max_seq=max_seq, device=dev)
        for impl in ("pallas", "blockwise")}
    # warm-up at the counted run's shapes (cuBLAS handles and heuristics,
    # the allocator's blocks), off the counted run
    engines["pallas"].generate(prompts, max_new_tokens=2)
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    shared = RouteShare(cfg.num_layers) if cfg.is_moe else None
    tfa.launches = 0
    tda.launches = 0
    with (shared.recording(shared.idx) if shared
          else contextlib.nullcontext()):
        res = engines["pallas"].generate(prompts, max_new_tokens=new)
    launches = {"flash_attention": tfa.launches,
                "decode_attention": tda.launches}
    out.update(launches=launches, prefill_seconds=res.prefill_seconds,
               decode_seconds=res.decode_seconds,
               decode_tokens_per_s=batch * new / res.decode_seconds,
               decode_ms_per_step=1e3 * res.decode_seconds / new)
    if on_card:
        out["peak_memory_bytes"] = torch.cuda.max_memory_allocated(dev)
    # the same generate again, every attention call held against the plain
    # version on that call's own inputs
    chk = AttentionCheck(torch, tfa, tda)
    undo = chk.install(tops)
    try:
        res_chk = engines["pallas"].generate(prompts, max_new_tokens=new)
    finally:
        undo()
    per_call = chk.summary()
    plain512 = ServeEngine(cfg, params, recipe=Recipe(
        remat="none", attn_impl="blockwise", block_kv=512), max_seq=max_seq,
        device=dev)
    if shared:
        free = []
        with shared.recording(free):
            free_ref = engines["blockwise"].generate(prompts, 1)
        free_512 = plain512.generate(prompts, 1)
        lf = free_ref.prefill_logits
        out["moe_free_routing"] = dict(
            differing_token_layers=shared.differing_tokens(free),
            prefill_logits_rel_err_vs_blockwise=_rel(
                res.prefill_logits, lf),
            blockwise_block512_rel_err_vs_blockwise=_rel(
                free_512.prefill_logits, lf))
        del free_ref, free_512
    with (shared.replaying() if shared else contextlib.nullcontext()):
        ref = engines["blockwise"].generate(prompts,
                                            max_new_tokens=min(8, new))
    lk, lr = res.prefill_logits, ref.prefill_logits
    rel = float((lk - lr).abs().max() / lr.abs().max())
    # the plain path against itself in another float32 summation order
    # (512-key blocks): how far bf16 rounding alone moves these logits
    with (shared.replaying() if shared else contextlib.nullcontext()):
        self_ref = plain512.generate(prompts, max_new_tokens=1)
    spread = float((self_ref.prefill_logits - lr).abs().max())
    first = res.tokens[:, prompt_len:prompt_len + 8]
    first_ref = ref.tokens[:, prompt_len:prompt_len + 8]
    # step 1 agrees up to ties: where the tokens differ, the plain path's
    # logits of the two must lie within what the plain path's own
    # reordering moves a logit (audio: one row a (sequence, codebook))
    lr_rows = lr.reshape(-1, cfg.vocab_size)
    tok, tok_ref = first[:, 0].reshape(-1), first_ref[:, 0].reshape(-1)
    rows = np.nonzero(tok != tok_ref)[0]
    gaps = [float(lr_rows[r, int(tok_ref[r])] - lr_rows[r, int(tok[r])])
            for r in rows]
    steps_equal = (first == first_ref).reshape(batch, first.shape[1], -1)
    out.update(per_call_vs_plain=per_call,
               check_run_tokens_equal=bool(
                   (res_chk.tokens == res.tokens).all()),
               prefill_logits_max_abs=float(lr.abs().max()),
               prefill_logits_rel_err_vs_blockwise=rel,
               blockwise_block512_rel_err_vs_blockwise=spread / float(
                   lr.abs().max()),
               tokens=first.tolist(), tokens_blockwise=first_ref.tolist(),
               first_tokens_blockwise512=self_ref.tokens[:, prompt_len]
               .tolist(),
               tokens_equal_steps=int(steps_equal.all(axis=(0, 2)).cumprod()
                                      .sum()),
               step1_differing_rows=rows.tolist(),
               step1_logit_gaps=gaps, step1_tie_tolerance=spread,
               blockwise_prefill_seconds=ref.prefill_seconds)
    del self_ref, ref, res_chk
    logits_tol = LOGITS_TOL
    if spread_gate:
        logits_tol = max(LOGITS_TOL, 2 * spread / float(lr.abs().max()))
        out["logits_gate"] = logits_tol
    want_f = attention_layers(cfg)
    want = {"flash_attention": want_f, "decode_attention": want_f * new}
    checks = []
    if on_card:
        checks.append((launches == want, f"{cfg.name} launches {launches}: "
                                         f"expected {want}"))
    for name, pc in per_call.items():
        if pc["calls"]:
            checks.append((pc["max_err_over_max_ref"] <= ATTN_ULP_REL,
                           f"{name} on the {cfg.name} path: call "
                           f"{pc['worst_call']} differs from the plain "
                           f"version by {pc['max_err_over_max_ref']:.3g} of "
                           f"its largest output > 2**-7"))
    want_shape = (batch,) + ((cfg.num_codebooks,) if cfg.family == "audio"
                             else ()) + (cfg.vocab_size,)
    checks += [
        (tuple(lk.shape) == want_shape and bool(torch.isfinite(lk).all()),
         f"{cfg.name}: prefill logits not finite or not {want_shape}"),
        (rel <= logits_tol, f"{cfg.name}: prefill logits vs blockwise: "
                            f"{rel:.3g} > {logits_tol:.3g}"),
        (all(g <= spread for g in gaps),
         f"{cfg.name}: first generated token differs from blockwise beyond "
         f"a tie: {tok} vs {tok_ref}, logit gaps {gaps} > {spread:.3g}")]
    return dict(out=out, checks=checks, first=chk.first, launches=launches,
                engine=engines["pallas"], prompts=prompts, params=params)


def serve_phase(args, torch, np, dev, on_card, tfa, tda, tops):
    """Phase 6: yi-34b at full width (``reduced`` on the CPU)."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.serve import kv_plan_line

    full = get_config("yi-34b")
    run = serve_model(args, torch, np, dev, on_card, tfa, tda, tops,
                      full if on_card else reduced(full), "serve")
    out = run["out"]
    out["kv_plan"] = kv_plan_line(full, dev)
    if on_card:
        out["profile"] = profile_serve(torch, run["engine"], run["prompts"],
                                       steps=4)
    emit(out)                      # the phase's numbers before its checks
    for cond, what in run["checks"]:
        check(cond, what)
    return out, run["first"], run["launches"]


# ---------------------------------------------------------------------------
# The other families: MoE, VLM, audio, the Zamba2 hybrid, RWKV6
# ---------------------------------------------------------------------------

#: The families phase's configs, each at full width and depth on the card.
#: phi3.5-moe-42b-a6.6b (~83.7 GB of bf16 weights) does not fit one 80 GB
#: card and is not run.
FAMILY_ARCHS = ("qwen2-moe-a2.7b", "qwen2-vl-7b", "musicgen-medium",
                "rwkv6-3b", "zamba2-2.7b")
RECURRENCE_TOKENS = 256
STATE_RTOL = 1e-3     # chunked prefill state vs the stepwise recurrence


def vlm_prefill_check(torch, np, cfg, params, dev, on_card, tfa, prompts):
    """The vision merger and M-RoPE prefill (which the engine, tokens only,
    never reaches): ``prefill_fn`` with ``vision_embeds`` and
    ``positions_3d`` shaped as ``input_specs`` gives them, under the flash
    kernel and the blockwise plain path."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.distributed.sharding import Recipe, ShardingCtx
    from repro_torch.models import model as model_mod

    b, s = prompts.shape
    specs = model_mod.input_specs(cfg, ShapeSpec("vlm", "prefill", s, b))
    rng = np.random.default_rng(7)
    nv = cfg.num_vision_tokens
    i = np.arange(s)
    # vision patches on a (t, h, w) grid, the text after them
    grid = int(np.sqrt(nv))
    pos = np.where(i < nv, 0, i - nv + grid)
    pos3 = np.stack([pos, np.where(i < nv, i // grid, pos),
                     np.where(i < nv, i % grid, pos)])
    batch = {"tokens": torch.as_tensor(prompts.astype(np.int64), device=dev),
             "vision_embeds": torch.as_tensor(rng.standard_normal(
                 tuple(specs["vision_embeds"].shape)).astype(np.float32),
                 device=dev),
             "positions_3d": torch.as_tensor(
                 np.broadcast_to(pos3[:, None], (3, b, s)).astype(np.int32),
                 device=dev)}
    for name, spec in specs.items():
        check(tuple(batch[name].shape) == tuple(spec.shape),
              f"vlm input {name}: {tuple(batch[name].shape)} vs spec "
              f"{tuple(spec.shape)}")
    logits = {}
    with torch.inference_mode():
        for name, impl, block in (("pallas", "pallas", 1024),
                                  ("blockwise", "blockwise", 1024),
                                  ("blockwise512", "blockwise", 512)):
            ctx = ShardingCtx(None, Recipe(remat="none", block_kv=block,
                                           attn_impl=impl))
            f0 = tfa.launches
            logits[name], _ = model_mod.prefill_fn(params, cfg, batch, ctx)
            if name == "pallas":
                flash = tfa.launches - f0
        text_only, _ = model_mod.prefill_fn(
            params, cfg, {"tokens": batch["tokens"]},
            ShardingCtx(None, Recipe(remat="none", attn_impl="pallas")))
    lk, lr = logits["pallas"], logits["blockwise"]
    rel = _rel(lk, lr)
    spread = _rel(logits["blockwise512"], lr)
    gate = max(LOGITS_TOL, 2 * spread)      # as serve_model's spread_gate
    out = dict(vision_embeds=list(specs["vision_embeds"].shape),
               positions_3d=list(specs["positions_3d"].shape),
               flash_launches=flash, logits_rel_err_vs_blockwise=rel,
               blockwise_block512_rel_err_vs_blockwise=spread,
               logits_gate=gate, rel_change_vs_text_only=_rel(lk, text_only))
    checks = [(bool(torch.isfinite(lk).all()), "vlm prefill: logits not "
                                               "finite"),
              (rel <= gate, f"vlm prefill with vision inputs vs "
                            f"blockwise: {rel:.3g} > {gate:.3g}"),
              (out["rel_change_vs_text_only"] > LOGITS_TOL,
               "vlm prefill: the vision inputs do not move the logits")]
    if on_card:
        checks.append((flash == attention_layers(cfg),
                       f"vlm prefill: {flash} flash launches, expected "
                       f"{attention_layers(cfg)}"))
    return out, checks


def recurrence_check(torch, np, cfg, params, dev, n):
    """The chunked prefill against the stepwise decode recurrence on an
    ``n``-token prompt, in float32 (the bf16 weights widened: the point is
    the algorithm, not bf16 rounding): last logits within ``LOGITS_TOL``
    and the first layer's (group's) state leaves within ``STATE_RTOL`` of
    their max-abs.  Every layer's error is recorded: at zamba2's depth
    float32 rounding grows ~2.5x a group (1.5e-5 in the first to ~3e-2 in
    the ninth), as its bf16 plain path moves 0.3 under a reordering."""
    import dataclasses as dc

    from repro_torch.configs.base import ShapeSpec
    from repro_torch.distributed.sharding import Recipe, ShardingCtx
    from repro_torch.models import model as model_mod

    def widen(tree):
        return {k: widen(v) if isinstance(v, dict) else v.float()
                for k, v in tree.items()}

    cfg32 = dc.replace(cfg, dtype="float32")
    p32 = widen(params)
    b = SERVE_BATCH
    toks = torch.as_tensor(family_prompts(np, cfg, np.random.default_rng(3),
                                          b, n).astype(np.int64), device=dev)
    ctx = ShardingCtx(None, Recipe(remat="none", attn_impl="pallas"))
    t0 = time.perf_counter()
    with torch.inference_mode():
        lp, sp = model_mod.prefill_fn(p32, cfg32, {"tokens": toks}, ctx)
        specs = model_mod.cache_specs(cfg32, ShapeSpec("rec", "decode", n, b))
        state = {k: torch.zeros(v.shape, dtype=torch.float32, device=dev)
                 for k, v in specs.items()}
        for t in range(n):
            lengths = torch.full((b,), t, dtype=torch.int32, device=dev)
            ls, state = model_mod.decode_fn(
                p32, cfg32, {"tokens": toks[:, t:t + 1], "lengths": lengths},
                state, ctx)
    seconds = time.perf_counter() - t0
    # per layer (RWKV) or group (hybrid): the leading index of every leaf
    states = {k: [_rel(a[:, :n] if k in ("k", "v") else a, b)
                  for a, b in zip(state[k], v)] for k, v in sp.items()}
    first = {k: v[0] for k, v in states.items()}
    rel = _rel(lp, ls)
    del p32, sp, state
    checks = [(rel <= LOGITS_TOL, f"{cfg.name}: chunked prefill logits vs "
                                  f"the stepwise recurrence {rel:.3g} > "
                                  f"{LOGITS_TOL}"),
              (max(first.values()) <= STATE_RTOL,
               f"{cfg.name}: chunked prefill states vs the stepwise "
               f"recurrence {first} > {STATE_RTOL}"),
              (bool(torch.isfinite(lp).all()), f"{cfg.name}: chunked "
                                               f"prefill logits not finite")]
    return dict(tokens=n, dtype="float32", seconds=seconds,
                logits_rel_err=rel, state_rel_err=states), checks


def families_phase(args, torch, np, dev, on_card, mods, tops):
    """Phase 7: every other family at full width and depth, one line each
    (the serve line's numbers and gates).  Returns the counted generates'
    summed launches and the hybrid's first flash and decode calls."""
    from repro_torch.configs import get_config, reduced

    tfa, tda = mods["flash_attention"], mods["decode_attention"]
    total = {name: 0 for name, _, _ in COUNTERS}
    d80_first = None
    t_phase = time.perf_counter()
    for arch in FAMILY_ARCHS:
        full = get_config(arch)
        cfg = full if on_card else reduced(full)
        zero_counters(mods)
        run = serve_model(args, torch, np, dev, on_card, tfa, tda, tops,
                          cfg, "families", spread_gate=True)
        # the attention kernels' counts are the counted generate's; the
        # CAM kernels' cover the whole family run and must stay 0
        counted = {**read_counters(mods), **run["launches"]}
        out, checks = run["out"], list(run["checks"])
        for name, n in counted.items():
            total[name] += n
            if name not in run["launches"]:
                checks.append((n == 0, f"{cfg.name}: {name} launched {n} "
                                       f"times on the serve path"))
        if cfg.family == "vlm":
            out["vision_prefill"], more = vlm_prefill_check(
                torch, np, cfg, run["params"], dev, on_card, tfa,
                run["prompts"])
            checks += more
        if cfg.family in ("rwkv", "hybrid"):
            out["recurrence"], more = recurrence_check(
                torch, np, cfg, run["params"], dev,
                min(RECURRENCE_TOKENS, args.prompt_len))
            checks += more
        if cfg.head_dim == 80 and run["first"]:
            d80_first = run["first"]
        emit(out)                  # the line's numbers before its checks
        for cond, what in checks:
            check(cond, what)
        del run
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
    emit({"phase": "families_done", "seconds": time.perf_counter() - t_phase,
          "launches": total,
          "not_run": {"phi3.5-moe-42b-a6.6b": "~83.7 GB of bf16 weights "
                                              "exceed one 80 GB card"}})
    return total, d80_first


def profile_serve(torch, engine, prompts, steps: int):
    """Device time by kernel class over one prefill and ``steps`` decode
    steps under ``torch.profiler``, and the device's busy share of the
    profiled wall time (the profiler's host overhead included)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = engine.generate(prompts, max_new_tokens=steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    classes = {"flash_attention": 0.0, "decode_attention": 0.0, "gemm": 0.0,
               "other": 0.0}
    attention = {}            # the port's attention kernels one by one
    top = []
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:   # kernels only: a host op's
            continue                             # time repeats its kernels'
        us = float(evt.self_device_time_total)
        if us <= 0:
            continue
        name = evt.key
        top.append((us, name[:80], evt.count))
        if "flash_fwd" in name or "decode_fwd" in name:
            short = name.split("::")[-1].split("(")[0]
            attention[short] = dict(us=us, count=evt.count,
                                    us_per_launch=us / evt.count)
        if "flash_fwd" in name:
            classes["flash_attention"] += us
        elif "decode_fwd" in name:
            classes["decode_attention"] += us
        elif any(t in name.lower() for t in ("gemm", "gemv", "cutlass",
                                             "sm90_xmma", "nvjet")):
            classes["gemm"] += us
        else:
            classes["other"] += us
    busy = sum(classes.values()) / 1e6
    top.sort(reverse=True)
    return {"steps": steps, "wall_seconds": wall,
            "prefill_seconds": res.prefill_seconds,
            "decode_seconds": res.decode_seconds,
            "device_seconds_by_class": {k: v / 1e6 for k, v in
                                        classes.items()},
            "device_busy_share": busy / wall if busy else None,
            "attention_kernels": attention,
            "top_kernels": [dict(us=u, name=n, count=c)
                            for u, n, c in top[:12]]}


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def time_attention(torch, tfa, tda, first, phase, **tags):
    """The flash and decode kernels at one path's shapes (each one's first
    call): error vs the plain version, held to one bf16 ulp of the largest
    output, CUDA-event times, bound and SDPA's time.  Emits one line a
    kernel and returns their numbers by kernel name."""
    out = {}
    q, k, v, causal = first["flash_attention"]
    ref = tfa.flash_attention_ref(q, k, v, causal=causal)
    held = hold_ulp(f"flash_attention at the {phase} shape", ulp_stats(
        torch, tfa.flash_attention(q, k, v, causal=causal), ref))
    lib = sdpa_flash(torch, q, k, v, causal).transpose(1, 2)
    err_lib_f = float((lib.float() - ref.float()).abs().max())
    del ref, lib
    nbytes, ops = flash_work(q, k, causal)
    b_ms, b_by = bound(nbytes, ops, BF16_FLOPS_PER_S
                       if q.dtype == torch.bfloat16 else F32_FLOPS_PER_S)
    ms, call_ms = cuda_times(lambda: tfa.flash_attention(q, k, v,
                                                         causal=causal))
    plain = cuda_ms(lambda: tfa.flash_attention_ref(q, k, v, causal=causal),
                    reps=3, warmup=1)
    lib_ms = cuda_ms(lambda: sdpa_flash(torch, q, k, v, causal))
    out["flash_attention"] = dict(
        shape={"q": list(q.shape), "kv": list(k.shape),
               "dtype": str(q.dtype), "causal": causal},
        **held, sdpa_max_abs_err_vs_plain=err_lib_f, bytes=nbytes, ops=ops,
        ms=ms, call_ms=call_ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
        tflop_per_s=ops / ms / 1e9, library_ms=lib_ms,
        library_tflop_per_s=ops / lib_ms / 1e9)

    q, kc, vc, lengths = first["decode_attention"]
    ref = tda.decode_attention_ref(q, kc, vc, lengths)
    held = hold_ulp(f"decode_attention at the {phase} shape", ulp_stats(
        torch, tda.decode_attention(q, kc, vc, lengths), ref))
    lib = sdpa_decode(torch, q, kc, vc, lengths).transpose(1, 2)
    err_lib_d = float((lib.float() - ref.float()).abs().max())
    del ref, lib
    nbytes, ops = decode_work(q, kc, lengths)
    b_ms, b_by = bound(nbytes, ops, BF16_FLOPS_PER_S
                       if q.dtype == torch.bfloat16 else F32_FLOPS_PER_S)
    ms, call_ms = cuda_times(lambda: tda.decode_attention(q, kc, vc,
                                                          lengths), reps=50)
    plain = cuda_ms(lambda: tda.decode_attention_ref(q, kc, vc, lengths),
                    reps=20)
    lib_ms = cuda_ms(lambda: sdpa_decode(torch, q, kc, vc, lengths), reps=50)
    out["decode_attention"] = dict(
        shape={"q": list(q.shape), "cache": list(kc.shape),
               "lengths": lengths.tolist(), "dtype": str(q.dtype)},
        **held, sdpa_max_abs_err_vs_plain=err_lib_d, bytes=nbytes, ops=ops,
        ms=ms, call_ms=call_ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
        gb_per_s=nbytes / ms / 1e6,
        splits=list(tda.decode_splits(
            q.shape[0], kc.shape[2], kc.shape[1],
            torch.cuda.get_device_properties(q.device)
            .multi_processor_count)),
        library_ms=lib_ms, library_gb_per_s=nbytes / lib_ms / 1e6)
    for name, row in out.items():
        emit({"phase": phase, "kernel": name, **tags, **row})
    return out


def attention_rows(torch, tfa, tda, first, launches):
    """The flash and decode rows of the kernels line, at the serve path's
    shapes."""
    timed = time_attention(torch, tfa, tda, first, "kernels_main")
    rows = []
    for name, line in (("flash_attention", 118), ("decode_attention", 82)):
        t = timed[name]
        rows.append(dict(
            name=name, route="cuda",
            source=f"src/repro_torch/kernels/csrc/{name}.cu",
            replaces=f"src/repro/kernels/{name}.py:{line}",
            launches=launches[name], max_abs_err=t["max_abs_err"],
            ms=t["ms"], call_ms=t["call_ms"], plain_ms=t["plain_ms"],
            bound_ms=t["bound_ms"], bound_by=t["bound_by"],
            library_ms=t["library_ms"]))
    return rows


# ---------------------------------------------------------------------------
# The training path: starcoder2-3b at full width and depth
# ---------------------------------------------------------------------------

TRAIN_ARCH = "starcoder2-3b"
TRAIN_STEPS = 8
LOSS_RTOL_F32 = 2e-2        # bf16 step vs float32 step, same masters/batch
GRAD_NORM_RTOL_F32 = 5e-2
SUPERVISOR_FAIL_AT = 30     # the train_lm leg's injected failure


def split_train_step(torch, step_fn, state, batch):
    """One more train step with the AdamW update timed apart (a device
    sync on each side of it): (state, gradient seconds, update seconds)."""
    from repro_torch.train import optimizer as opt_mod

    real, took = opt_mod.adamw_update, {}

    def timed(*a, **kw):
        torch.cuda.synchronize()
        took["grads"] = time.perf_counter() - t0
        out = real(*a, **kw)
        torch.cuda.synchronize()
        took["adamw"] = time.perf_counter() - t0 - took["grads"]
        return out

    opt_mod.adamw_update = timed      # train_step calls it through the module
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = step_fn(state, batch)
    finally:
        opt_mod.adamw_update = real
    return state, took["grads"], took["adamw"]


def profile_train_step(torch, step_fn, state, batch):
    """One more train step under ``torch.profiler``: device seconds of the
    GEMMs and of everything else, kernel launches, and the device's busy
    share of the profiled wall time (the profiler's overhead included)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = step_fn(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    gemm = other = 0.0
    launches = 0
    top = []
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        us = float(evt.self_device_time_total)
        if us <= 0:
            continue
        launches += evt.count
        top.append((us, evt.key[:80], evt.count))
        if any(t in evt.key.lower() for t in ("gemm", "gemv", "cutlass",
                                               "sm90_xmma", "nvjet")):
            gemm += us
        else:
            other += us
    top.sort(reverse=True)
    busy = (gemm + other) / 1e6
    return state, {"wall_seconds": wall, "gemm_seconds": gemm / 1e6,
                   "other_seconds": other / 1e6, "kernel_launches": launches,
                   "device_busy_share": busy / wall if busy else None,
                   "top_kernels": [dict(us=u, name=n, count=c)
                                   for u, n, c in top[:12]]}


def supervisor_leg(args, torch, dev, on_card):
    """``repro_torch.launch.train_lm`` twice at its full configuration
    (``--smoke`` on the CPU): uninterrupted, and with an injected failure
    that the Supervisor answers by restoring the last checkpoint and
    replaying the pipeline."""
    from repro_torch.launch import train_lm

    smoke = not on_card
    fail_at = SUPERVISOR_FAIL_AT if on_card else 4
    whole = train_lm.run(smoke=smoke, seed=args.seed, torch_device=dev)
    faulted = train_lm.run(smoke=smoke, seed=args.seed, torch_device=dev,
                           fail_at=(fail_at,))
    a, b = whole["losses"][-1], faulted["losses"][-1]
    out = {"smoke": smoke, "params": whole["params"],
           "batch": whole["batch"], "seq": whole["seq"],
           "steps": whole["steps"], "fail_at": fail_at,
           "seconds": [whole["seconds"], faulted["seconds"]],
           "tokens_per_s": whole["tokens_per_s"],
           "first_loss": whole["losses"][0], "last_loss": a,
           "faulted_last_loss": b, "last_loss_rel_diff": abs(a - b) / abs(a),
           "restarts": faulted["restarts"],
           "final_step": faulted["final_step"],
           "faulted_steps_run": len(faulted["losses"])}
    checks = [
        (whole["restarts"] == 0 and faulted["restarts"] == 1,
         f"supervisor leg: restarts {whole['restarts']}, "
         f"{faulted['restarts']} (want 0, 1)"),
        (whole["final_step"] == faulted["final_step"] == whole["steps"],
         f"supervisor leg: final steps {whole['final_step']}, "
         f"{faulted['final_step']} (want {whole['steps']})"),
        (abs(a - b) <= 1e-6 * abs(a),
         f"supervisor leg: last losses {a} and {b} differ by more than "
         f"1e-6 relative")]
    # the smoke's 8 warmup steps move the loss less than the batches do,
    # so only the full run's decrease is a gate
    if on_card:
        checks.append((whole["loss_decreasing"] and faulted["loss_decreasing"],
                       f"supervisor leg: loss did not decrease "
                       f"({whole['losses'][0]} -> {a}, faulted -> {b})"))
    return out, checks


def train_phase(args, torch, np, dev, on_card, mods):
    """Phase 8: starcoder2-3b trained at full width and depth (``reduced``
    on the CPU) through ``repro_torch.launch.train.build_trainer``, a
    float32 step beside the bf16 one, the ``pallas`` refusal, and the
    Supervisor leg.  Returns the phase's kernel launches (all 0)."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.distributed.sharding import Recipe, ShardingCtx
    from repro_torch.launch.train import build_trainer
    from repro_torch.models.attention import attention
    from repro_torch.models.params import init_params
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train import train_step as ts_mod

    t_phase = time.perf_counter()
    full = get_config(TRAIN_ARCH)
    cfg = full if on_card else reduced(full)
    batch_n, seq = (4, 1024) if on_card else (4, 128)
    recipe = Recipe(remat="block", microbatch=1, attn_impl="blockwise")
    opt_cfg = opt_mod.AdamWConfig(lr=3e-4, warmup_steps=5,
                                  total_steps=TRAIN_STEPS,
                                  moment_dtype=cfg.opt_moment_dtype)
    zero_counters(mods)

    def sync():
        if on_card:
            torch.cuda.synchronize()

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = init_params(cfg, gen, dtype=torch.float32, device=dev)
    sync()
    t_init = time.perf_counter() - t0
    numel = sum(x.numel() for _, x in opt_mod.leaves(params))
    n_model = cfg.param_count()
    pipe = TokenPipeline(cfg.vocab_size, batch_n, seq, seed=args.seed)
    to_dev = lambda b: {k: torch.as_tensor(v, device=dev)
                        for k, v in b.items()}

    # the float32 reading: step 0's gradients with a float32 compute copy
    # (the masters themselves) from the same masters and batch
    t0 = time.perf_counter()
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    loss32, g32 = ts_mod._grads_fn(params, to_dev(pipe.batch_for_step(0)),
                                   cfg32, ShardingCtx(None, recipe))
    gn32 = float(opt_mod.global_norm(g32))
    loss32 = float(loss32)
    t_f32 = time.perf_counter() - t0
    del g32
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    state = {"params": params,
             "opt_state": ts_mod.init_opt_state(params, cfg, recipe,
                                                opt_cfg)}
    del params
    step_fn = build_trainer(cfg, recipe, opt_cfg, device=dev)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    seconds, losses, norms, lrs = [], [], [], []
    for i in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, m = step_fn(state, pipe.batch_for_step(i))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        lrs.append(float(m["lr"]))
        sync()
        seconds.append(time.perf_counter() - t0)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 if on_card else None
    prof = None
    if on_card:      # two more steps, past the 8 counted ones
        state, g_s, a_s = split_train_step(torch, step_fn, state,
                                           pipe.batch_for_step(TRAIN_STEPS))
        state, prof = profile_train_step(
            torch, step_fn, state, pipe.batch_for_step(TRAIN_STEPS + 1))
        prof.update(split_step={"grads_seconds": g_s, "adamw_seconds": a_s})
    launches = read_counters(mods)

    # neither attention kernel has a backward: the pallas route refuses
    g = torch.Generator(device=dev).manual_seed(args.seed)
    q, k, v = (torch.randn(1, 512, cfg.num_heads, cfg.head_dim,
                           generator=g, device=dev).to(torch.bfloat16)
               for _ in range(3))
    q.requires_grad_()
    try:
        attention(q, k, v, impl="pallas")
        refused = False
    except ValueError as e:
        refused = "no backward kernel" in str(e)
    del state, q, k, v
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    sup, sup_checks = supervisor_leg(args, torch, dev, on_card)
    tokens = batch_n * seq
    med = float(np.median(seconds[1:]))
    bound_s = 8 * n_model * tokens / BF16_FLOPS_PER_S   # remat: fwd twice
    out = {"phase": "train", "arch": cfg.name, "params": n_model,
           "param_numel": numel, "batch": batch_n, "seq": seq,
           "steps": TRAIN_STEPS,
           "recipe": {"remat": recipe.remat, "microbatch": recipe.microbatch,
                      "attn_impl": recipe.attn_impl,
                      "grad_dtype": recipe.grad_dtype},
           "moment_dtype": opt_cfg.moment_dtype, "init_seconds": t_init,
           "step_seconds": seconds, "first_step_seconds": seconds[0],
           "median_step_seconds": med, "tokens_per_s": tokens / med,
           "mfu": 6 * n_model * tokens / (med * BF16_FLOPS_PER_S),
           "bound_step_seconds": bound_s, "peak_gb": peak_gb,
           "losses": losses, "grad_norms": norms, "lrs": lrs,
           "float32_check": {
               "loss_bf16": losses[0], "loss_f32": loss32,
               "loss_rel_diff": abs(losses[0] - loss32) / abs(loss32),
               "grad_norm_bf16": norms[0], "grad_norm_f32": gn32,
               "grad_norm_rel_diff": abs(norms[0] - gn32) / gn32,
               "seconds": t_f32},
           "profiled_step": prof, "launches": launches,
           "pallas_grad_refused": refused, "supervisor": sup,
           "seconds": time.perf_counter() - t_phase}
    emit(out)                      # the phase's numbers before its checks
    check(np.isfinite(losses + norms + [loss32, gn32]).all(),
          f"train: non-finite loss or grad norm: {losses}, {norms}")
    check(losses[-1] < losses[0], f"train: the loss did not decrease "
                                  f"({losses[0]} -> {losses[-1]})")
    fc = out["float32_check"]
    check(fc["loss_rel_diff"] <= LOSS_RTOL_F32,
          f"train: bf16 loss {losses[0]} vs float32 {loss32}")
    check(fc["grad_norm_rel_diff"] <= GRAD_NORM_RTOL_F32,
          f"train: bf16 grad norm {norms[0]} vs float32 {gn32}")
    check(not any(launches.values()),
          f"train: kernels launched on the train path: {launches}")
    check(refused, "train: attention(impl='pallas') took inputs that "
                   "require grad")
    for cond, what in sup_checks:
        check(cond, what)
    return launches


# ---------------------------------------------------------------------------
# Phase 9: the multi-device layer on a one-rank mesh of the card
# ---------------------------------------------------------------------------

DIST_STEPS = 3
DIST_RTOL = 1e-5           # mesh step vs mesh-less step, same masters/batch
SUPERVISOR_MESH_RTOL = 1e-6
#: The two representative production cells of the JAX dry-run tests.
DRYRUN_CELLS = (("starcoder2-3b", "decode_32k"), ("qwen2-moe-a2.7b", "train_4k"))


def dryrun_subprocess(cells):
    """Start ``launch.dryrun.run_cell`` on ``cells`` in a subprocess of its
    own (a fake process group, FakeTensorMode, the CPU only); returns the
    Popen, whose stdout's last line is the records as JSON."""
    code = (
        "import json, sys\n"
        "from repro_torch.configs.base import ShapeSpec\n"
        "from repro_torch.launch.dryrun import run_cell\n"
        "out = []\n"
        f"for kw in {cells!r}:\n"
        "    if isinstance(kw.get('shape_name'), dict):\n"
        "        kw['shape_name'] = ShapeSpec(**kw['shape_name'])\n"
        "    r = run_cell(verbose=False, **kw)\n"
        "    r.pop('trace', None)\n"
        "    out.append(r)\n"
        "print(json.dumps(out))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, cwd=str(ROOT))


def collect_dryrun(proc, timeout: float):
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise SmokeFailure(f"distributed: dry run did not end in {timeout} s")
    check(proc.returncode == 0,
          f"distributed: dry run exited {proc.returncode}: {err[-2000:]}")
    return json.loads(out.strip().splitlines()[-1])


def run_steps(torch, step_fn, params, opt_state, batches, sync):
    """Steps over ``batches``: (losses, grad norms, seconds a step)."""
    losses, norms, seconds = [], [], []
    for b in batches:
        t0 = time.perf_counter()
        params, opt_state, m = step_fn(params, opt_state, dict(b))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        sync()
        seconds.append(time.perf_counter() - t0)
    return params, opt_state, losses, norms, seconds


def distributed_phase(args, torch, np, dev, on_card, mods):
    """Phase 9: the distributed path of ``repro_torch`` on a one-rank
    mesh (NCCL on the card, gloo on the CPU): starcoder2-3b trained through
    ``launch.cells.build_cell`` on a (data 1, model 1) mesh against the
    mesh-less step, the pod-compressed step on (pod 1, data 1, model 1),
    the Supervisor restarting on the mesh, dry runs of this cell and of
    two production cells, and the H100 roofline.  Returns the phase's
    kernel launches (all 0)."""
    import tempfile

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_config, reduced
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.distributed import compression
    from repro_torch.distributed.sharding import Recipe
    from repro_torch.launch import train_lm
    from repro_torch.launch.analytic import cell_cost
    from repro_torch.launch.cells import build_cell
    from repro_torch.launch.mesh import H100
    from repro_torch.launch.roofline import roofline_table
    from repro_torch.models.params import init_params
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train import train_step as ts_mod

    t_phase = time.perf_counter()
    full = get_config(TRAIN_ARCH)
    cfg = full if on_card else reduced(full)
    batch_n, seq = (4, 1024) if on_card else (4, 128)
    shape = ShapeSpec(f"train_{batch_n}x{seq}", "train", seq, batch_n)
    recipe = Recipe(remat="block", microbatch=1, attn_impl="blockwise")
    opt_cfg = opt_mod.AdamWConfig(lr=3e-4, warmup_steps=5,
                                  total_steps=TRAIN_STEPS,
                                  moment_dtype=cfg.opt_moment_dtype)
    zero_counters(mods)

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def free():
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()

    store = tempfile.NamedTemporaryFile(prefix="chip_smoke_pg_", delete=False)
    store.close()
    dist.init_process_group("nccl" if on_card else "gloo",
                            init_method=f"file://{store.name}", rank=0,
                            world_size=1)
    dry_self = dry_prod = None
    try:
        dtype_dev = "cuda" if on_card else "cpu"
        mesh = init_device_mesh(dtype_dev, (1, 1),
                                mesh_dim_names=("data", "model"))
        pipe = TokenPipeline(cfg.vocab_size, batch_n, seq, seed=args.seed)
        batches = [{k: torch.as_tensor(v, device=dev)
                    for k, v in pipe.batch_for_step(i).items()}
                   for i in range(DIST_STEPS + 1)]

        # -- 1. the mesh-less step, then the same through build_cell --------
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(
            args.seed), dtype=torch.float32, device=dev)
        plain_step = ts_mod.make_train_step(cfg, recipe, None, opt_cfg)
        state = ts_mod.init_opt_state(params, cfg, recipe, opt_cfg)
        params, state, l0, n0, s0 = run_steps(torch, plain_step, params,
                                              state, batches[:DIST_STEPS],
                                              sync)
        del params, state
        free()
        fn, make_args = build_cell(cfg, shape, mesh, recipe, device=dev,
                                   opt_cfg=opt_cfg)
        params, state, _ = make_args(fake=False, seed=args.seed)
        placements = sorted({str(p.placements) for _, p in
                             opt_mod.leaves(params)})
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        params, state, l1, n1, s1 = run_steps(torch, fn, params, state,
                                              batches[:DIST_STEPS], sync)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9 if on_card else None
        prof = None
        if on_card:
            prof = profile_mesh_step(torch, fn, params, state,
                                     batches[DIST_STEPS])
        del params, state
        free()
        gap = [max(abs(a - b) / abs(b), abs(c - d) / abs(d))
               for a, b, c, d in zip(l1, l0, n1, n0)]
        step1 = {"mesh": [1, 1], "placements": placements,
                 "losses": l1, "grad_norms": n1,
                 "meshless_losses": l0, "meshless_grad_norms": n0,
                 "max_rel_gap": max(gap),
                 "step_seconds": s1, "meshless_step_seconds": s0,
                 "median_step_seconds": float(np.median(s1[1:])),
                 "meshless_median_step_seconds": float(np.median(s0[1:])),
                 "peak_gb": peak_gb, "profiled_step": prof}

        # -- 2. the pod-compressed step -------------------------------------
        pod_mesh = init_device_mesh(dtype_dev, (1, 1, 1),
                                    mesh_dim_names=("pod", "data", "model"))
        crecipe = dataclasses.replace(recipe, batch_axes=("pod", "data"),
                                      compress_pod_grads=True)
        fn_c, make_c = build_cell(cfg, shape, pod_mesh, crecipe, device=dev,
                                  opt_cfg=opt_cfg)
        params, state, _ = make_c(fake=False, seed=args.seed)
        real, comp = compression.compressed_pod_mean, {"seconds": []}

        def timed(grads, ef, m):
            sync()
            t0 = time.perf_counter()
            out = real(grads, ef, m)
            sync()
            comp["seconds"].append(time.perf_counter() - t0)
            if "bound" not in comp:     # step 0: quantization error per leaf
                # ef starts at 0, so the new ef is g - deq(q(g)); the
                # means are deq, whose max-abs is 127 x the scale
                worst, over = 0.0, 0
                for (_, g), (_, e) in zip(opt_mod.leaves(out[0]),
                                          opt_mod.leaves(out[1])):
                    g, e = g.full_tensor(), e.full_tensor()
                    scale = float(g.abs().max()) / 127.0
                    err = float(e.abs().max())
                    worst = max(worst, err / (scale / 2) if scale else 0.0)
                    over += err > scale * 0.5 + 1e-6
                comp["bound"] = worst    # max |deq - g| over scale/2
                comp["leaves_over"] = over
            return out

        ts_mod.compression.compressed_pod_mean = timed
        try:
            if on_card:
                torch.cuda.reset_peak_memory_stats()
            params, state, lc, nc, sc = run_steps(torch, fn_c, params, state,
                                                  batches[:DIST_STEPS], sync)
        finally:
            ts_mod.compression.compressed_pod_mean = real
        cpeak = torch.cuda.max_memory_allocated() / 1e9 if on_card else None
        del params, state
        free()
        # step 0 holds the first call's warm-up and the per-leaf gate
        # above (full_tensor, max-abs and error of every leaf): the share
        # is read from step 1 on
        step2 = {"mesh": [1, 1, 1], "depth": cfg.num_layers,
                 "losses": lc, "grad_norms": nc, "step_seconds": sc,
                 "compress_seconds": comp["seconds"],
                 "compress_share": [c / s for c, s in zip(
                     comp["seconds"][1:], sc[1:])],
                 "median_step_seconds": float(np.median(sc[1:])),
                 "step0_err_over_half_scale": comp["bound"],
                 "step0_leaves_over_bound": comp["leaves_over"],
                 "peak_gb": cpeak}

        # -- 3. the Supervisor on the mesh, the dry runs beside it ---------
        # (they use the CPU alone; started after the timed steps 1 and 2,
        # whose host-bound dispatch they would slow)
        if on_card:
            dry_self = dryrun_subprocess([dict(
                arch=TRAIN_ARCH, shape_name=dataclasses.asdict(shape),
                mesh_shape=(1, 1))])
            dry_prod = dryrun_subprocess([dict(arch=a, shape_name=s)
                                          for a, s in DRYRUN_CELLS])
        smoke = not on_card
        fail_at = SUPERVISOR_FAIL_AT if on_card else 4
        whole = train_lm.run(smoke=smoke, seed=args.seed, torch_device=dev,
                             mesh=mesh)
        faulted = train_lm.run(smoke=smoke, seed=args.seed, torch_device=dev,
                               fail_at=(fail_at,), mesh=mesh)
        a, b = whole["losses"][-1], faulted["losses"][-1]
        step3 = {"smoke": smoke, "steps": whole["steps"], "fail_at": fail_at,
                 "seconds": [whole["seconds"], faulted["seconds"]],
                 "last_loss": a, "faulted_last_loss": b,
                 "last_loss_rel_diff": abs(a - b) / abs(a),
                 "restarts": [whole["restarts"], faulted["restarts"]],
                 "final_step": faulted["final_step"]}
        free()
    except BaseException:
        for proc in (dry_self, dry_prod):     # stop what this phase started
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.communicate()
        raise
    finally:
        dist.destroy_process_group()
        os.unlink(store.name)

    # -- 4. dry runs: this cell against the card, two production cells ---------
    step4 = None
    if on_card:
        mine = collect_dryrun(dry_self, 600)[0]
        prod = collect_dryrun(dry_prod, 600)
        mem = mine.get("memory", {})
        step4 = {"cell": {k: mine.get(k) for k in ("status", "mesh",
                                                    "recipe", "memory",
                                                    "compile_seconds")},
                 "predicted_peak_gb": mem.get("peak_bytes", 0) / 1e9,
                 "measured_peak_gb": peak_gb,
                 "predicted_over_measured": mem.get("peak_bytes", 0) / 1e9
                 / peak_gb,
                 "production": [
                     {"arch": r["arch"], "shape": r["shape"],
                      "mesh": r["mesh"], "status": r["status"],
                      "error": r.get("error"),
                      "peak_gb": r.get("memory", {}).get("peak_bytes", 0)
                      / 1e9,
                      "fits_80g": r.get("memory", {}).get("fits_80g"),
                      "seconds": r.get("compile_seconds"),
                      "collectives": r.get("collectives")} for r in prod]}

    # -- 5. the H100 roofline ----------------------------------------------------
    cost = cell_cost(cfg, shape, recipe, {"data": 1, "model": 1})
    terms = cost.terms(H100, 1)
    step5 = {"terms_s": terms, "bound_step_seconds": max(terms.values()),
             "measured_step_seconds": step1["median_step_seconds"],
             "measured_over_bound": step1["median_step_seconds"]
             / max(terms.values())}
    table = [{k: r.get(k) for k in ("arch", "shape", "mesh", "status",
                                    "dominant", "step_time_lower_bound_s",
                                    "roofline_fraction")}
             for r in roofline_table(hw=H100)]
    launches = read_counters(mods)
    out = {"phase": "distributed", "arch": cfg.name, "batch": batch_n,
           "seq": seq, "steps": DIST_STEPS,
           "total_memory": torch.cuda.get_device_properties(0).total_memory
           if on_card else None,
           "h100_hbm_bytes": H100.hbm_bytes,
           "mesh_step": step1, "compressed": step2, "supervisor": step3,
           "dryrun": step4, "roofline": step5, "launches": launches,
           "seconds": time.perf_counter() - t_phase}
    emit(out)                      # the phase's numbers before its checks
    emit({"phase": "distributed_roofline_h100", "rows": table})
    check(step1["max_rel_gap"] <= DIST_RTOL,
          f"distributed: mesh step vs mesh-less step: {step1['max_rel_gap']}"
          f" relative (losses {l1} vs {l0}, norms {n1} vs {n0})")
    check(np.isfinite(lc + nc).all(),
          f"distributed: compressed step not finite: {lc}, {nc}")
    check(comp["leaves_over"] == 0,
          f"distributed: {comp['leaves_over']} leaves' int8 error passed "
          f"scale/2 + 1e-6 (worst {comp['bound']} of scale/2)")
    check(step3["restarts"] == [0, 1],
          f"distributed: Supervisor restarts {step3['restarts']} (want 0, 1)")
    check(step3["final_step"] == step3["steps"],
          f"distributed: final step {step3['final_step']}")
    check(abs(a - b) <= SUPERVISOR_MESH_RTOL * abs(a),
          f"distributed: Supervisor last losses {a} and {b}")
    if on_card:
        check(step4["cell"]["status"] == "ok",
              f"distributed: dry run of the card's cell: {step4['cell']}")
        for r in step4["production"]:
            check(r["status"] == "ok", f"distributed: dry run {r}")
    check(not any(launches.values()),
          f"distributed: kernels launched on the train path: {launches}")
    return launches


def profile_mesh_step(torch, fn, params, state, batch):
    """One more mesh step under ``torch.profiler`` (phase 8's reading)."""
    step = lambda st, b: (lambda r: ({"p": r[0], "s": r[1]}, r[2]))(
        fn(st["p"], st["s"], dict(b)))
    _, prof = profile_train_step(torch, step, {"p": params, "s": state},
                                 batch)
    return prof


# ---------------------------------------------------------------------------
# The join path: the paper's §VII-A join setup at the main path's 1/10 cut
# ---------------------------------------------------------------------------

JOIN_EPS = 64          # examples/hybrid_join.py and the README's quickstart
TREE_EPS = 32          # examples/join_tree.py
CHOICE_BOUND = 1.10    # tests/test_join_session.py: choice vs replayed best
JOIN_QERR_BOUND = 2.0  # tests/test_join_session.py: plan I/O vs replay
CURVE_CAPS = 8
COUNTERS = (("price_grid", "price_grid", "launches"),
            ("profile_grid", "profile_grid", "launches"),
            ("che_sums", "che_solver", "launches"),
            ("che_solve", "che_solver", "solve_launches"),
            ("flash_attention", "flash_attention", "launches"),
            ("decode_attention", "decode_attention", "launches"))


def zero_counters(mods):
    for _, mod, attr in COUNTERS:
        setattr(mods[mod], attr, 0)


def read_counters(mods):
    return {name: getattr(mods[mod], attr) for name, mod, attr in COUNTERS}


class PriceLog:
    """Every ``PricingEngine.price`` call of a path: engine, table and
    solution, so each table can be priced again through the host
    executor."""

    def __init__(self):
        self.calls = []

    def install(self, engine_cls):
        real, log = engine_cls.price, self

        def price(engine, table, **kw):
            sol = real(engine, table, **kw)
            log.calls.append((engine, table, sol))
            return sol

        engine_cls.price = price
        return lambda: setattr(engine_cls, "price", real)


def join_phase(args, torch, np, mods, keys, pgm, sync, on_card):
    """The join layer at the paper's §VII-A join setup (1M outer probes,
    200M inner keys, a 16 MiB buffer) scaled by ``--keys`` / 200M:
    calibration, strategy choice against replay of all four strategies,
    cost curves, a three-level join tree, and every ``price_grid`` call
    held to its plain version and to the host executor."""
    from repro_torch.configs.cam_paper import PAPER
    from repro_torch.core.cam import CamGeometry
    from repro_torch.core.qerror import q_error
    from repro_torch.core.session import System
    from repro_torch.data.workloads import WorkloadSpec, join_outer_keys
    from repro_torch.engine.table import PricingEngine
    from repro_torch.index.adapters import PGMAdapter
    from repro_torch.join.session import STRATEGIES, JoinSession
    from repro_torch.join.tree import JoinTreeSession

    tpg = mods["price_grid"]
    ratio = args.keys / PAPER.join_inner
    n_outer = max(1, round(PAPER.join_outer * ratio))
    buffer_bytes = PAPER.join_buffer_bytes * ratio
    secs = {}
    t0 = time.perf_counter()
    inner = pgm.build({"eps": JOIN_EPS})
    tree_keys = [keys, keys[::2].copy(), keys[::3].copy()]
    tree_inners = [PGMAdapter.build(k, TREE_EPS) for k in tree_keys]
    secs["index_builds"] = time.perf_counter() - t0
    outer = join_outer_keys(keys, n_outer,
                            WorkloadSpec("w4", seed=args.seed + 3))
    tree_outer = join_outer_keys(keys, n_outer,
                                 WorkloadSpec("w1", seed=args.seed + 4))
    system = System(CamGeometry(), buffer_bytes + inner.size_bytes, "lru",
                    torch_device=args.device)
    tree_system = System(
        CamGeometry(), buffer_bytes + sum(a.size_bytes for a in tree_inners),
        "lfu", torch_device=args.device)

    recorder, log = Recorder(keep_all=True), PriceLog()
    undo = [recorder.install(tpg, mods["profile_grid"]),
            log.install(PricingEngine)]
    zero_counters(mods)
    t_path = time.perf_counter()
    try:
        t0 = time.perf_counter()
        sess = JoinSession(inner, system, inner_keys=keys)
        params = sess.calibrate(seed=args.seed)
        secs["calibrate"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        choice = sess.choose(outer)
        secs["choose"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        stats = {s: sess.execute(choice.plans[s]) for s in STRATEGIES}
        secs["execute_4_strategies"] = time.perf_counter() - t0
        secs["execute_by_strategy"] = {s: st.wall_seconds
                                       for s, st in stats.items()}
        lo = min(64, sess.capacity)
        caps = np.unique(np.geomspace(lo, max(4 * sess.capacity, lo + 7),
                                      CURVE_CAPS).round().astype(np.int64))
        t0 = time.perf_counter()
        curve = sess.cost_curve(outer, caps)
        sync()
        secs["cost_curve"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        tree = JoinTreeSession(tree_inners, tree_system, tree_keys)
        tree.calibrate(seed=args.seed)
        tree_plan = tree.plan(tree_outer, grid=8)
        sync()
        secs["tree_plan"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        tree_stats = tree.execute(tree_plan)
        secs["tree_execute"] = time.perf_counter() - t0
    finally:
        for u in reversed(undo):
            u()
    secs["join_path"] = time.perf_counter() - t_path
    launches = read_counters(mods)

    # ---- kernel and executor checks (launches here are not counted) -----
    t0 = time.perf_counter()
    price_err, zero_rows = 0.0, 0
    for call, flags in recorder.price_calls:
        f32s = call["f32s"]
        zero_rows += int(((f32s[:, 0] == 0) & (f32s[:, 4] > 0)).sum())
        price_err = max(price_err, compare_price(tpg, call, flags, 1e-5))
    dh, executors = 0.0, sorted({sol.executor for _, _, sol in log.calls})
    for engine, table, sol in log.calls:
        host = PricingEngine(engine.cost, executor="host").price(
            table, objective=sol.objective_name)
        dh = max(dh, float(np.abs(sol.hit_rates - host.hit_rates).max()))
    timing = []
    for call, flags in recorder.price_calls if on_card else ():
        nbytes, ops = price_work(call, flags)
        b_ms, b_by = bound(nbytes, ops)
        ms, call_ms = cuda_times(lambda: run_price(tpg.price_grid, call,
                                                   flags))
        plain = cuda_ms(lambda: run_price(tpg.price_grid_ref, call, flags),
                        reps=3, warmup=1)
        timing.append(dict(
            shape=list(call["probs"].shape) + [call["caps_i"].shape[1]],
            policy=call["policy"], has_sorted=bool(flags["has_sorted"]),
            ms=ms, call_ms=call_ms, plain_ms=plain, bound_ms=b_ms,
            bound_by=b_by))
    secs["checks"] = time.perf_counter() - t0

    replayed = {s: st.seconds for s, st in stats.items()}
    best = min(replayed, key=replayed.get)
    qerr = {s: float(q_error(choice.plans[s].cost.physical_ios,
                             max(stats[s].physical_ios, 1)))
            for s in STRATEGIES}
    rise = {s: max(0.0, float(np.diff(curve.physical_ios[s]).max()
                              / max(curve.physical_ios[s].max(), 1.0)))
            for s in STRATEGIES}
    table3 = ("lambda_point", "lambda_range", "alpha", "beta", "eta",
              "delta")
    out = {
        "phase": "join", "inner_keys": len(keys), "outer_probes": n_outer,
        "buffer_bytes": buffer_bytes, "capacity_pages": sess.capacity,
        "inner_pages": sess.num_pages, "index_eps": JOIN_EPS,
        "reduced": [
            f"inner keys {PAPER.join_inner:,} -> {len(keys):,} (books, "
            f"seed {args.seed}; the main path's cut)",
            f"outer probes {PAPER.join_outer:,} -> {n_outer:,} (the same "
            "ratio, so probes per inner page stay the paper's)",
            f"buffer {PAPER.join_buffer_bytes / 2**20:g} MiB -> "
            f"{buffer_bytes / 2**20:.4g} MiB (the same ratio)"],
        "seconds": secs,
        "calibration": {"fitted": {k: getattr(params, k) for k in table3},
                        "paper_table3": {k: getattr(PAPER, k)
                                         for k in table3},
                        "note": "fitted against the simulated machine"},
        "strategies": {s: dict(
            predicted_seconds=choice.costs[s].seconds,
            predicted_io=choice.costs[s].physical_ios,
            replayed_seconds=stats[s].seconds,
            replayed_io=stats[s].physical_ios, io_q_error=qerr[s],
            segments=stats[s].n_segments,
            range_segments=stats[s].n_range_segments,
            matches=stats[s].matches) for s in STRATEGIES},
        "chosen": choice.strategy, "replayed_best": best,
        "chosen_over_best_replayed": replayed[choice.strategy]
        / replayed[best],
        "inlj_over_hybrid_replayed": replayed["inlj"] / replayed["hybrid"],
        "cost_curve": {"capacities": caps.tolist(),
                       "io": {s: curve.physical_ios[s].tolist()
                              for s in STRATEGIES},
                       "max_relative_rise": rise},
        "tree": {"levels": tree.n_levels, "pool_pages": tree.pool_pages,
                 "policy": tree_system.policy,
                 "fractions": list(tree_plan.fractions),
                 "capacities": list(tree_plan.capacities),
                 "strategies": list(tree_plan.strategies),
                 "predicted_seconds": tree_plan.cost.seconds,
                 "replayed_seconds": tree_stats.seconds,
                 "predicted_io": tree_plan.cost.physical_ios,
                 "replayed_io": tree_stats.physical_ios,
                 "matches": tree_stats.matches},
        "launches": launches, "engine_calls": len(log.calls),
        "executors": executors, "price_grid_calls": len(recorder.price_calls),
        "zero_histogram_sorted_rows": zero_rows,
        "price_grid_max_abs_err": price_err, "max_abs_dh_vs_host": dh,
        "price_grid_at_join_shapes": timing}
    emit(out)                      # the phase's numbers before its checks

    check(replayed[choice.strategy] <= CHOICE_BOUND * replayed[best],
          f"join: chose {choice.strategy} ({replayed[choice.strategy]:.4g} "
          f"s replayed), best {best} ({replayed[best]:.4g} s)")
    for s in STRATEGIES:
        check(qerr[s] < JOIN_QERR_BOUND, f"join {s}: I/O q-error "
                                         f"{qerr[s]:.3f} >= {JOIN_QERR_BOUND}")
        check(rise[s] <= 1e-6, f"join {s}: cost curve rises with capacity "
                               f"({rise[s]:.3g} of its largest value)")
    check(abs(sum(tree_plan.fractions) - 1.0) < 1e-9
          and sum(tree_plan.capacities) <= tree.pool_pages
          and np.isfinite(tree_stats.seconds) and tree_stats.logical_refs > 0,
          f"join tree: plan {tree_plan.fractions} / {tree_plan.capacities}")
    check(price_err <= 1e-5, f"join price_grid vs plain {price_err:.3g}")
    check(dh <= 1e-5, f"join: device vs host executor max |dh| {dh:.3g}")
    if on_card:
        check(launches["price_grid"] > 0, "price_grid never launched on "
                                          "the join path")
        check(executors == ["device"], f"join path priced through "
                                       f"{executors}, not the kernel")
    return launches


# ---------------------------------------------------------------------------
# The online layers: serving sketch and drift loop, sharded fleet, write path
# ---------------------------------------------------------------------------

H_BOUND = 2e-6        # tests/test_engine.py: hit rates between two paths
#: ``benchmarks/bench_serving_drift.py`` at its full configuration, seed 0,
#: run by the JAX package on the CPU: each arm's total I/O and rebuilds.
#: The reference reads static/adaptive 1.000 there (its adaptive arm never
#: rebuilds: at 400,000 keys a rebuild costs 1,691 page I/Os, more than
#: the 30,000-query horizon saves), so its own 1.2x gate fails at this
#: size; the port is held to the reference's numbers instead.
JAX_FULL_SERVING = {"static": (45194.15193327516, 0),
                    "adaptive": (45194.15193327516, 0),
                    "every_drift": (54305.46912032366, 10),
                    "oracle": (31548.905714198947, 0)}


@contextlib.contextmanager
def executor(name):
    """Every engine call inside the block prices through executor ``name``
    (``REPRO_ENGINE_EXECUTOR``, read per call); ``None`` leaves the
    engine's own rule (the device executor on the card)."""
    if name is None:
        yield
        return
    os.environ["REPRO_ENGINE_EXECUTOR"] = name
    try:
        yield
    finally:
        del os.environ["REPRO_ENGINE_EXECUTOR"]


def drive(mods, fn, on_card):
    """Run one online path with its launch counters zeroed just before and
    read just after, every ``price_grid`` call and engine call recorded.
    The CPU rehearsal asks for the device executor (the kernel's plain
    version on CPU tensors), which the card picks by itself."""
    from repro_torch.engine.table import PricingEngine

    recorder, log = Recorder(keep_all=True), PriceLog()
    undo = [recorder.install(mods["price_grid"], mods["profile_grid"]),
            log.install(PricingEngine)]
    zero_counters(mods)
    t0 = time.perf_counter()
    try:
        with executor(None if on_card else "device"):
            out = fn()
    finally:
        for u in reversed(undo):
            u()
    seconds = time.perf_counter() - t0
    return out, read_counters(mods), recorder.price_calls, log.calls, seconds


def rerun_on_host(mods, fn):
    """The same path again through the host executor (its engine calls
    recorded; launches here are not counted)."""
    from repro_torch.engine.table import PricingEngine

    log = PriceLog()
    undo = log.install(PricingEngine)
    try:
        with executor("host"):
            out = fn()
    finally:
        undo()
    return out, log.calls


def io_close(got, want, dac) -> bool:
    """I/O per query within rtol 1e-5, or within the 2e-6 hit-rate bound
    carried through (1 - h) E[DAC] where h is within float32 ulps of 1."""
    return abs(got - want) <= max(1e-5 * abs(want), H_BOUND * dac)


def paired_calls(name, dev_calls, host_calls):
    """Engine calls of the device run against the host rerun, in order:
    the same tables, h within 1e-5 and I/O by ``io_close`` cell by cell.
    Returns (max |dh|, max relative I/O difference)."""
    import numpy as np
    check(len(dev_calls) == len(host_calls),
          f"{name}: {len(dev_calls)} engine calls on the card, "
          f"{len(host_calls)} on the host executor")
    dh = rel = 0.0
    for (_, tab_d, sol_d), (_, tab_h, sol_h) in zip(dev_calls, host_calls):
        check(len(tab_d) == len(tab_h), f"{name}: table sizes differ")
        dh = max(dh, float(np.abs(sol_d.hit_rates - sol_h.hit_rates).max()))
        dacs = np.asarray(tab_h.profiles.dacs)[tab_h.rows]
        for a, b, dac in zip(sol_d.io, sol_h.io, dacs):
            check(io_close(float(a), float(b), float(dac)),
                  f"{name}: cell I/O {a} on the card vs {b} on the host")
            if b:
                rel = max(rel, abs(float(a) - float(b)) / abs(float(b)))
    check(dh <= 1e-5, f"{name}: device vs host executor max |dh| {dh:.3g}")
    return dh, rel


def hold_path(name, tpg, launches, price_calls, engine_calls, on_card):
    """Every recorded kernel call against its plain version (1e-5), and on
    the card: ``price_grid`` launched, nothing else, every engine call
    priced through the device executor."""
    err = max((compare_price(tpg, call, flags, 1e-5)
               for call, flags in price_calls), default=0.0)
    executors = sorted({sol.executor for _, _, sol in engine_calls})
    if on_card:
        check(launches["price_grid"] > 0,
              f"price_grid never launched on the {name} path")
        others = {k: v for k, v in launches.items() if k != "price_grid"}
        check(not any(others.values()),
              f"{name} path launched other kernels: {others}")
        check(executors == ["device"],
              f"{name} path priced through {executors}, not the kernel")
    return err, executors


def price_shape(call):
    return list(call["probs"].shape) + [call["caps_i"].shape[1]]


def price_row_timing(tpg, path, label, call, flags, launches):
    """A kernels_main line for one recorded ``price_grid`` call."""
    nbytes, ops = price_work(call, flags)
    b_ms, b_by = bound(nbytes, ops)
    ms, call_ms = cuda_times(lambda: run_price(tpg.price_grid, call, flags))
    plain = cuda_ms(lambda: run_price(tpg.price_grid_ref, call, flags),
                    reps=3, warmup=1)
    emit(dict(phase="kernels_main", kernel="price_grid", path=path,
              table=label, shape=price_shape(call), policy=call["policy"],
              has_sorted=bool(flags["has_sorted"]),
              has_write=bool(flags["has_write"]), launches=launches,
              ms=ms, call_ms=call_ms, plain_ms=plain, bound_ms=b_ms,
              bound_by=b_by, bytes=nbytes, ops=ops))


def largest(price_calls):
    return max(price_calls, key=lambda cf: cf[0]["probs"].numel()
               * cf[0]["caps_i"].shape[1])


def serving_phase(args, torch, np, mods, world, pgm, sync, on_card):
    """Leg (a): the drift benchmark's full configuration, all four arms:
    at ``--smoke`` sizes both its gates held, at full size its rebuild gate
    held and every arm held to the JAX reference's totals (whose 1.2x gate
    fails there; recorded).  Leg (b): the adaptive arm on the main path's
    keys and budget, timed per batch, its static/adaptive ratio recorded."""
    import repro_torch.serving.session as serving_session
    from repro_torch.launch import bench_serving_drift as bsd
    from repro_torch.serving import synthetic_drifting_trace
    from repro_torch.serving.trace import iter_batches
    from repro_torch.tuning.session import TuningSession

    tpg = mods["price_grid"]
    smoke = not on_card

    def leg_a():
        return bsd.measure(smoke=smoke, seed=args.seed,
                           torch_device=args.device)

    with contextlib.redirect_stdout(io.StringIO()):
        rec, launches_a, calls_a, engine_a, secs_a = drive(mods, leg_a,
                                                           on_card)
    err_a, ex_a = hold_path("serving", tpg, launches_a, calls_a, engine_a,
                            on_card)
    with contextlib.redirect_stdout(io.StringIO()):
        host, host_engine = rerun_on_host(mods, leg_a)
    for arm in ("adaptive", "every_drift"):
        got, want = rec["arms"][arm], host["arms"][arm]
        check(got["rebuilds"] == want["rebuilds"]
              and len(got["decisions"]) == len(want["decisions"]),
              f"serving {arm}: decisions differ on the host executor")
        for d, h in zip(got["decisions"], want["decisions"]):
            check((d["ts"], d["switched"], d["from_knob"], d["to_knob"])
                  == (h["ts"], h["switched"], h["from_knob"], h["to_knob"]),
                  f"serving {arm}: decision at {d['ts']} differs")
            for f in ("io_current", "io_candidate"):
                check(io_close(d[f], h[f], h["dac"]),
                      f"serving {arm} {f}: {d[f]} vs {h[f]}")
    check(rec["arms"]["oracle"]["configs"]
          == host["arms"]["oracle"]["configs"],
          "serving oracle: configurations differ on the host executor")
    dh_a, rel_a = paired_calls("serving", engine_a, host_engine)
    total_rel = max(abs(rec["arms"][a]["total_io"]
                        - host["arms"][a]["total_io"])
                    / host["arms"][a]["total_io"] for a in rec["arms"])

    # ---- leg (b): the main path's keys and budget, adaptive arm only -----
    keys, system = world["keys"], world["system"]
    scale = 384 if smoke else 2048
    segs = bsd.segments(scale)
    t0 = time.perf_counter()
    events = synthetic_drifting_trace(keys, segs, seed=args.seed)
    trace_seconds = time.perf_counter() - t0
    warmup, stream = events[:segs[0]["events"]], events[segs[0]["events"]:]
    cfg = bsd.serving_config(scale, smoke=False)
    batches = list(iter_batches(stream, cfg.batch_size))
    timed = {"update": [], "to_profiles": [], "retune": [], "compile": []}

    def timer(name, real):
        def timed_call(*a, **kw):
            t = time.perf_counter()
            out = real(*a, **kw)
            sync()
            timed[name].append(time.perf_counter() - t)
            return out
        return timed_call

    def instrument(srv):
        for name, owner, attr in (("update", srv.sketch, "update"),
                                  ("to_profiles", srv.sketch, "to_profiles"),
                                  ("retune", srv, "_retune")):
            setattr(owner, attr, timer(name, getattr(owner, attr)))

    def leg_b():
        return bsd.serve_arm(keys, system, pgm, cfg, warmup, batches,
                             on_session=instrument)

    # the trace's compile into workloads (both call sites), timed apart
    undo = [(mod, mod.compile_events) for mod in (bsd, serving_session)]
    for mod, real in undo:
        mod.compile_events = timer("compile", real)
    try:
        (srv, spans, rebuild_io), launches_b, calls_b, engine_b, secs_b = \
            drive(mods, leg_b, on_card)
    finally:
        for mod, real in undo:
            mod.compile_events = real
    err_b, ex_b = hold_path("serving at scale", tpg, launches_b, calls_b,
                            engine_b, on_card)
    t0 = time.perf_counter()
    tuning = TuningSession(system)
    adaptive_io = bsd.charge(tuning, pgm, spans) + rebuild_io
    static_io = bsd.charge(tuning, pgm, [(spans[0][0], [
        wl for _, wls in spans for wl in wls])])
    charge_seconds = time.perf_counter() - t0
    sketch_bytes = sum(t.numel() * t.element_size() for c in srv.sketch.chunks
                       for t in (c.counts, c.sorted_coverage, c.write_counts)
                       if t is not None)
    launches = {k: launches_a[k] + launches_b[k] for k in launches_a}
    out = {
        "phase": "serving",
        "leg_a": {
            "config": {"keys": rec["n"], "buffer_kb": rec["buffer_kb"],
                       "eps_grid": rec["eps_grid"], "smoke": rec["smoke"],
                       "queries": rec["queries"]},
            "arms": {a: {k: v for k, v in r.items() if k != "decisions"}
                     for a, r in rec["arms"].items()},
            "decisions": {a: rec["arms"][a]["decisions"]
                          for a in ("adaptive", "every_drift")},
            "static_over_adaptive_io": rec["static_over_adaptive_io"],
            "gates": rec["gates"], "seconds": secs_a,
            "launches": launches_a, "engine_calls": len(engine_a),
            "price_grid_calls": len(calls_a), "executors": ex_a,
            "price_grid_max_abs_err": err_a, "max_abs_dh_vs_host": dh_a,
            "max_rel_cell_io_vs_host": rel_a,
            "max_rel_arm_io_vs_host": total_rel,
            "largest_table": price_shape(largest(calls_a)[0])
            if calls_a else None},
        "leg_b": {
            "keys": len(keys), "pages": system.geom.num_pages(len(keys)),
            "budget_bytes": system.memory_budget_bytes,
            "events": len(events), "warmup_batches": len(list(
                iter_batches(warmup, cfg.batch_size))),
            "stream_batches": len(batches), "batch_size": cfg.batch_size,
            "trace_seconds": trace_seconds, "seconds": secs_b,
            "charge_seconds": charge_seconds,
            "update_seconds": timed["update"],
            "to_profiles_seconds": timed["to_profiles"],
            "retune_seconds": timed["retune"],
            "compile_events_seconds": sum(timed["compile"]),
            "compile_events_calls": len(timed["compile"]),
            "sketch_device_bytes": sketch_bytes,
            "stats": dataclasses.asdict(srv.stats),
            "decisions": bsd.decisions(srv),
            "deployed": {"eps": srv.current.best_knob,
                         "capacity_pages": srv.current.capacity_pages},
            "static_io": static_io, "adaptive_io": adaptive_io,
            "static_over_adaptive_io": static_io / adaptive_io,
            "launches": launches_b, "engine_calls": len(engine_b),
            "price_grid_calls": len(calls_b), "executors": ex_b,
            "price_grid_max_abs_err": err_b,
            "largest_table": price_shape(largest(calls_b)[0])
            if calls_b else None},
        "launches": launches}
    reference = not smoke and args.seed == 0
    if reference:
        out["leg_a"]["jax_reference"] = {
            a: {"total_io": io_, "rebuilds": rb,
                "rel_diff": rec["arms"][a]["total_io"] / io_ - 1.0}
            for a, (io_, rb) in JAX_FULL_SERVING.items()}
    emit(out)                      # the phase's numbers before its checks
    check(rec["gates"]["fewer_rebuilds_than_every_drift"],
          f"serving: adaptive rebuilds {rec['arms']['adaptive']['rebuilds']}"
          f", every_drift {rec['arms']['every_drift']['rebuilds']}")
    if reference:
        for a, (io_, rb) in JAX_FULL_SERVING.items():
            got = rec["arms"][a]
            check(got["rebuilds"] == rb
                  and abs(got["total_io"] - io_) <= 1e-5 * io_,
                  f"serving {a}: {got['total_io']} I/O, {got['rebuilds']} "
                  f"rebuilds; the JAX reference {io_}, {rb}")
    else:
        check(all(rec["gates"].values()), f"serving gates: {rec['gates']} "
              f"(static/adaptive {rec['static_over_adaptive_io']:.3f})")
    check(srv.sketch.updates == len(timed["update"])
          == out["leg_b"]["warmup_batches"] + len(batches),
          "serving at scale: one sketch update per batch")
    check(len(engine_b) == 1 + srv.stats.retune_evaluations,
          "serving at scale: one engine call per retune")
    check(np.isfinite(adaptive_io) and np.isfinite(static_io),
          "serving at scale: non-finite I/O")
    if on_card:
        price_row_timing(tpg, "serving", "largest (scale leg)",
                         *largest(calls_b), launches["price_grid"])
        price_row_timing(tpg, "serving", "largest (benchmark leg)",
                         *largest(calls_a), launches["price_grid"])
    return launches


def sharding_phase(args, torch, np, mods, sync, on_card):
    """The sharding benchmark's full configuration under lru, fifo and lfu,
    its 1.15x gate held per policy."""
    from repro_torch.launch import bench_sharding as bsh

    tpg = mods["price_grid"]

    def run():
        return bsh.measure(smoke=not on_card, seed=args.seed,
                           torch_device=args.device)

    with contextlib.redirect_stdout(io.StringIO()):
        rec, launches, calls, engine, secs = drive(mods, run, on_card)
    err, executors = hold_path("sharding", tpg, launches, calls, engine,
                               on_card)
    with contextlib.redirect_stdout(io.StringIO()):
        host, host_engine = rerun_on_host(mods, run)
    for p in bsh.POLICIES:
        got, want = rec["policies"][p], host["policies"][p]
        keys_ = ("boundaries", "fractions", "eps", "capacities",
                 "even_fractions", "even_eps", "cells_solved")
        check(all(got[k] == want[k] for k in keys_),
              f"sharding {p}: the plan differs on the host executor")
    dh, rel = paired_calls("sharding", engine, host_engine)
    out = {"phase": "sharding", "config": {
               k: rec[k] for k in ("n", "queries", "n_shards", "budget_grid",
                                   "node_budget_kb", "fleet_budget_kb",
                                   "hot_slab_pages", "eps_grid", "smoke")},
           "policies": rec["policies"], "gates": rec["gates"],
           "seconds": secs, "launches": launches,
           "engine_calls": len(engine), "price_grid_calls": len(calls),
           "table_shapes": [price_shape(c) for c, _ in calls],
           "executors": executors, "price_grid_max_abs_err": err,
           "max_abs_dh_vs_host": dh, "max_rel_cell_io_vs_host": rel}
    emit(out)
    check(all(rec["gates"].values()), f"sharding gates: {rec['gates']}")
    if on_card:
        price_row_timing(tpg, "sharding", "largest", *largest(calls),
                         launches["price_grid"])
    return launches


def updatable_tunes(args, n, memory_pages):
    """The updatable adapters (ALEX's gapped array, the B+-tree) tuned on a
    read/write mix over the write benchmark's keys and buffer: the caller
    that prices write streams (``has_write``) through the engine."""
    import numpy as np
    from repro_torch.core.session import System
    from repro_torch.core.workload import Workload
    from repro_torch.launch import bench_write_path as bwp
    from repro_torch.tuning.session import (ALEXBuilder, BTreeBuilder,
                                            TuningSession)

    keys = np.sort(np.random.default_rng(args.seed + 1).uniform(0, 1e9, n))
    rng = np.random.default_rng(args.seed + 5)
    wl = Workload.mixed(Workload.point(rng.integers(0, n, n // 4), n=n),
                        Workload.insert(rng.integers(0, n, n // 8), n=n))
    system = System(bwp.GEOM, memory_pages * bwp.GEOM.page_bytes, "lru",
                    torch_device=args.device)
    return {name: TuningSession(system).tune(builder(keys), wl)
            for name, builder in (("alex", ALEXBuilder),
                                  ("btree", BTreeBuilder))}


def write_phase(args, torch, np, mods, sync, on_card):
    """The write-path benchmark's full configuration, three arms, its
    gates and one engine call per decision event held; then the updatable
    adapters' read/write tunes."""
    from repro_torch.launch import bench_write_path as bwp

    tpg = mods["price_grid"]

    def run():
        rec = bwp.measure(smoke=not on_card, seed=args.seed,
                          torch_device=args.device)
        return rec, updatable_tunes(args, rec["n"], rec["memory_pages"])

    with contextlib.redirect_stdout(io.StringIO()):
        (rec, tunes), launches, calls, engine, secs = drive(mods, run,
                                                            on_card)
    err, executors = hold_path("write", tpg, launches, calls, engine,
                               on_card)
    with contextlib.redirect_stdout(io.StringIO()):
        (host, host_tunes), host_engine = rerun_on_host(mods, run)
    for arm, got in rec["arms"].items():
        want = host["arms"][arm]
        check((got["merged_batches"], got["reasons"], got["merges"])
              == (want["merged_batches"], want["reasons"], want["merges"]),
              f"write {arm}: merge decisions differ on the host executor")
    for name, got in tunes.items():
        want = host_tunes[name]
        check((got.best, got.split, got.capacity_pages)
              == (want.best, want.split, want.capacity_pages),
              f"write {name} tune differs on the host executor")
        check(io_close(got.est_io, want.est_io,
                       want.estimates[want.best_knob].dac),
              f"write {name} est_io {got.est_io} vs {want.est_io}")
    dh, rel = paired_calls("write", engine, host_engine)
    sizes = [len(t) for _, t, _ in engine]
    shapes = [price_shape(c) + [int(f["has_write"])] for c, f in calls]
    by_shape = {}
    for sh in shapes:
        by_shape[str(sh)] = by_shape.get(str(sh), 0) + 1
    decision_events = sum(a["decision_events"] for a in rec["arms"].values())
    out = {"phase": "write", "config": {
               k: rec[k] for k in ("n", "events", "memory_pages", "config",
                                   "smoke")},
           "arms": {a: {k: v for k, v in r.items() if k != "reasons"}
                    for a, r in rec["arms"].items()},
           "on_full_over_cam_io": rec["on_full_over_cam_io"],
           "every_k_over_cam_io": rec["every_k_over_cam_io"],
           "gates": rec["gates"],
           "updatable_tunes": {name: dict(
               best=t.best, split=t.split, capacity_pages=t.capacity_pages,
               est_io=t.est_io, batched_solves=t.batched_solves)
               for name, t in tunes.items()},
           "seconds": secs, "launches": launches,
           "engine_calls": len(engine), "decision_events": decision_events,
           "cells_per_engine_call": sizes, "price_grid_calls": len(calls),
           "table_shapes_rows_pages_cells_has_write": by_shape,
           "has_write_calls": sum(int(f["has_write"]) for _, f in calls),
           "executors": executors, "price_grid_max_abs_err": err,
           "max_abs_dh_vs_host": dh, "max_rel_cell_io_vs_host": rel}
    emit(out)
    check(all(rec["gates"].values()), f"write gates: {rec['gates']}")
    check(len(engine) == decision_events + len(tunes),
          f"write: {len(engine)} engine calls for {decision_events} "
          f"decision events and {len(tunes)} tunes")
    check(out["has_write_calls"] == len(tunes) > 0,
          "write: the updatable tunes priced no write stream")
    if on_card:
        # the largest table is an updatable tune's (with write streams);
        # the decision events' tables are the typical one
        price_row_timing(tpg, "write", "largest (has_write)",
                         *largest(calls), launches["price_grid"])
        typical = max(by_shape, key=by_shape.get)
        call = next(cf for cf, sh in zip(calls, shapes)
                    if str(sh) == typical)
        price_row_timing(tpg, "write", "typical (decision event)", *call,
                         launches["price_grid"])
    return launches


def online_section(args, torch, np, mods, world, pgm, sync, on_card):
    """The three online paths; returns their summed launches."""
    t0 = time.perf_counter()
    total = {name: 0 for name, _, _ in COUNTERS}
    for run in (lambda: serving_phase(args, torch, np, mods, world, pgm,
                                      sync, on_card),
                lambda: sharding_phase(args, torch, np, mods, sync, on_card),
                lambda: write_phase(args, torch, np, mods, sync, on_card)):
        for k, v in run().items():
            total[k] += v
    emit({"phase": "online", "seconds": time.perf_counter() - t0,
          "launches": total})
    return total


# ---------------------------------------------------------------------------
# Main
# ---------------------------------------------------------------------------

def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--keys", type=int, default=None,
                    help="inner keys (default: the paper's 200M / 10)")
    ap.add_argument("--queries", type=int, default=1_000_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--prompt-len", type=int, default=1024)
    ap.add_argument("--new-tokens", type=int, default=32)
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

    from repro_torch.configs.cam_paper import PAPER
    if args.keys is None:
        args.keys = PAPER.keys_per_dataset // 10

    if args.device == "cuda" and not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; the port's "
              "kernels need an NVIDIA GPU", file=sys.stderr)
        return 1
    on_card = args.device == "cuda"
    from repro_torch.core import cache_models as tcm
    from repro_torch.kernels import _build
    from repro_torch.kernels import che_solver as tche
    from repro_torch.kernels import decode_attention as tda
    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.kernels import ops as tops
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
              "built": ["price_grid", "profile_grid", "che_sums",
                        "che_solve", "flash_attention", "decode_attention"],
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
        attn_small = small_attention_checks(torch, np, tfa, tda, tche, dev)
        sync()
        emit({"phase": "kernels_small", "price_variants": len(small),
              "price_max_abs_err": max(small),
              "profile_max_abs_err": max(prof_small), **attn_small})

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

    # ---- 3b. the Che path on the PGM tune's profile rows -------------------
    che_operands = None
    if ("lru", False, False) in recorder.price:
        che, che_operands = che_path(torch, tcm, tche, recorder)
        emit({"phase": "che_path", **che})
        if on_card:
            check(che["solves"] > 0 and che["solve_launches"] == che["solves"],
                  f"Che path: {che['solve_launches']} che_solve launches "
                  f"for {che['solves']} solves")
            check(che["che_sums_launches"] == 0, "Che path: che_sums "
                                                 "launched beside the solve")
            launches["che_solve"] = che["solve_launches"]
            launches["che_sums"] = che["che_sums_launches"]

    # ---- 4. kernels vs plain versions at the main path's shapes -----------
    kernels = []
    if on_card:
        kernels = main_shape_kernels(torch, np, tpg, tprof, dev, world, pgm,
                                     recorder, launches)
        kernels.append(che_row(torch, tche, che_operands,
                               launches["che_sums"]))
        kernels.append(che_solve_row(torch, tche, che_operands,
                                     launches["che_solve"]))

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

    # ---- 5b. the join path: §VII-A's join setup at the same cut ------------
    mods = {"price_grid": tpg, "profile_grid": tprof, "che_solver": tche,
            "flash_attention": tfa, "decode_attention": tda}
    join_launches = join_phase(args, torch, np, mods, world["keys"], pgm,
                               sync, on_card)

    # ---- 5c. the online layers: serving sketch, sharded fleet, write path --
    online_launches = online_section(args, torch, np, mods, world, pgm,
                                     sync, on_card)

    # ---- 6. the serving path: yi-34b at full width -------------------------
    del world, pgm, rmi, recorder, results, host, che_operands
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    serve, attn_first, serve_launches = serve_phase(
        args, torch, np, torch.device(args.device), on_card, tfa, tda, tops)
    print(serve["kv_plan"], flush=True)
    if on_card:
        kernels += attention_rows(torch, tfa, tda, attn_first,
                                  serve_launches)
    del attn_first
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    # ---- 7. the other families at full width -------------------------------
    family_launches, d80_first = families_phase(
        args, torch, np, torch.device(args.device), on_card, mods, tops)
    if on_card:
        check(d80_first is not None, "no head_dim-80 attention call on the "
                                     "families path")
        time_attention(torch, tfa, tda, d80_first, "kernels_other",
                       path="families/zamba2-2.7b", head_dim=80)
        del d80_first

    # ---- 8. the training path: starcoder2-3b at full width ---------------
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    train_launches = train_phase(args, torch, np, torch.device(args.device),
                                 on_card, mods)

    # ---- 9. the distributed path on a one-rank mesh of the card ------------
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    dist_launches = distributed_phase(args, torch, np,
                                      torch.device(args.device), on_card,
                                      mods)

    if not on_card:
        print("chip_smoke: CPU rehearsal finished; no result without a GPU",
              file=sys.stderr)
        return 3
    for row in kernels:
        row["join_launches"] = join_launches[row["name"]]
        row["online_launches"] = online_launches[row["name"]]
        row["families_launches"] = family_launches[row["name"]]
        row["train_launches"] = train_launches[row["name"]]
        row["distributed_launches"] = dist_launches[row["name"]]
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
        ms, call_ms = cuda_times(lambda: run_price(tpg.price_grid, call,
                                                   flags))
        plain = cuda_ms(lambda: run_price(tpg.price_grid_ref, call, flags),
                        reps=3, warmup=1)
        steps = price_steps(tpg, call, flags)
        ran = steps[steps > 0].double()
        ex2 = price_ex2(call, flags, steps)
        detail["/".join(map(str, key))] = dict(
            shape=list(call["probs"].shape) + [call["caps_i"].shape[1]],
            ms=ms, call_ms=call_ms, plain_ms=plain, bound_ms=b_ms,
            bound_by=b_by, max_abs_err=err, bytes=nbytes, ops=ops,
            bisecting_cells=int(ran.numel()),
            steps_mean=float(ran.mean()) if ran.numel() else 0.0,
            steps_max=int(ran.max()) if ran.numel() else 0,
            ex2_count=ex2, ex2_reading_ms=ex2 / EX2_PER_S * 1e3)
        if call["policy"] == "multi":
            detail["/".join(map(str, key))]["policy_rows_ms"] = \
                price_policy_ms(tpg, call, flags)
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
        ms=head["ms"], call_ms=head["call_ms"], plain_ms=head["plain_ms"],
        bound_ms=head["bound_ms"], bound_by=head["bound_by"], library_ms=None)

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
    # the call is the page sort (with its tile plan and range checks, two
    # host syncs) and then the kernel; ms is the sum of their device times
    operands = dict(keys=call["keys"], pages=call["pages"], lut=call["lut"],
                    bands=call["bands"], c_ipp=call["c_ipp"], pad=call["pad"])
    sq = tprof.sort_queries(**operands)
    sort_ms = cuda_ms(lambda: tprof.sort_queries(**operands))
    kernel_ms = cuda_ms(lambda: tprof.launch_sorted(sq))
    ms = sort_ms + kernel_ms
    call_ms = cuda_times(lambda: run_profile(tprof.profile_grid, call))[1]
    flushes = torch.zeros(1, dtype=torch.int64, device=dev)
    tprof.launch_sorted(sq, flushes)
    flushes = int(flushes)
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
          "adds": adds, "bytes": nbytes, "ms": ms, "sort_ms": sort_ms,
          "kernel_ms": kernel_ms, "call_ms": call_ms,
          "tiles": sq.starts.numel() - 1, "global_flushes": flushes,
          "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
          "library_ms": library})
    profile_row = dict(
        name="profile_grid", route="cuda",
        source="src/repro_torch/kernels/csrc/profile_grid.cu",
        replaces="src/repro/kernels/profile_grid.py:134",
        launches=launches["profile_grid"], max_abs_err=max(err, err_exact),
        ms=ms, call_ms=call_ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
        library_ms=library)
    return [price_row, profile_row]


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
