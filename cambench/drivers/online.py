"""An index service retuning online: a closed-loop replay of a drifting op log.

Set-up makes the key file and the op log from ``--seed`` (the traffic's
segments, ``cambench.frozen.drift``), fits the PGM size model, warms a
throwaway session on one batch of each op mix, then starts the served
session on the warm segments.  Each step of the window compiles the next
batch of the stream (``serving.trace.compile_events``) and ingests it
(``ServingSession.ingest``: sketch, drift check, any retune and decision);
the stream replays cyclically.

The check replays the run through ``cambench.reference.online``: every
batch's located positions and TV distance, every evaluation and switch,
each retune's priced table and choice, and the window profiles of the
first evaluations.
"""
from __future__ import annotations

import contextlib

import numpy as np

from cambench.drivers.common import (Deployment, Window, checks_with_limits,
                                     memory_peak, settle)
from cambench.frozen.drift import drifting_trace
from cambench.harness import process_age
from cambench.reference.online import batch_parts

SPANS = ("compile", "sketch", "retune")


class Inputs(Deployment):
    """The deployment, its op log from the seed, cut into batches."""

    def __init__(self, ctx):
        super().__init__(ctx)
        tr = ctx.traffic
        self.serving = dict(tr["serving"])
        self.check_evaluations = int(tr["check_evaluations"])
        segs = tr["segments"]
        events = drifting_trace(self.n, segs, ctx.rng(3))
        warm_n = sum(s["events"] for s in segs[:tr["warm_segments"]])
        size = int(tr["batch_size"])
        self.batch_size = size
        self.warm = [events[a:a + size] for a in range(0, warm_n, size)]
        self.stream = [events[a:a + size]
                       for a in range(warm_n, len(events), size)]


def trace_events(batch, keys):
    from repro_torch.serving.trace import TraceEvent

    out = []
    for op, lo, hi, ts in batch:
        if op == "point":
            out.append(TraceEvent(op, key=float(keys[lo]), ts=ts))
        else:
            out.append(TraceEvent(op, lo_key=float(keys[lo]),
                                  hi_key=float(keys[hi]), ts=ts))
    return out


def answer_of(result, counts=None):
    """A TuneResult as plain values (see ``reference.online.follow``)."""
    return {"cells": {(kn, e.capacity_pages): (e.hit_rate, e.io, e.dac)
                      for kn, entries in result.table.items()
                      for e in entries},
            "est_io": result.est_io, "best": result.best_knob,
            "cap": result.capacity_pages, "counts": counts}


def run(ctx):
    import torch
    from repro_torch.core.cam import CamGeometry
    from repro_torch.core.session import System
    from repro_torch.serving import ServingConfig, ServingSession
    from repro_torch.serving.trace import compile_events
    from repro_torch.tuning.session import PGMBuilder, TuningSession

    inp = Inputs(ctx)
    system = System(CamGeometry(c_ipp=inp.c_ipp, page_bytes=inp.page_bytes),
                    inp.budget, inp.policy, torch_device=ctx.device)
    builder = PGMBuilder(inp.keys)
    sv = inp.serving
    scfg = ServingConfig(batch_size=inp.batch_size,
                         window_chunks=sv["window_chunks"],
                         page_bins=sv["page_bins"],
                         drift_threshold=sv["drift_threshold"],
                         hysteresis=sv["hysteresis"],
                         cooldown_batches=sv["cooldown_batches"],
                         horizon_queries=sv["horizon_queries"])
    overrides = {"eps": inp.grid}
    warm_events = [trace_events(b, inp.keys) for b in inp.warm]
    stream = [trace_events(b, inp.keys) for b in inp.stream]

    def session():
        return ServingSession(TuningSession(system, splits=inp.splits),
                              builder, inp.keys, overrides=overrides,
                              config=scfg)

    # warm every op mix of the stream on a throwaway session
    scratch = session()
    scratch.start(warm_events[0])
    seen = set()
    for b in stream:
        mix = frozenset(e.op for e in b)
        if mix not in seen:
            seen.add(mix)
            scratch.ingest(compile_events(b, inp.keys))
    del scratch

    srv = session()
    profiles = []
    real_retune = srv.tuning.tune_from_profiles

    def keep_profiles(bld, profs, *a, **kw):
        if len(profiles) <= inp.check_evaluations:
            profiles.append(profs)
        return real_retune(bld, profs, *a, **kw)

    srv.tuning.tune_from_profiles = keep_profiles
    initial = srv.start([e for b in warm_events for e in b])
    settle(torch, ctx.device)
    setup_s = process_age()

    win = Window(ctx, torch, SPANS)
    batches = []

    def step(i: int):
        j = i % len(stream)
        with win.spans.span("compile") if win.trace else \
                contextlib.nullcontext():
            wl = compile_events(stream[j], inp.keys)
        rep = srv.ingest(wl, ts=stream[j][-1].ts)
        batches.append((j, wl, rep))

    if win.trace:
        win.spans.wrap(srv.sketch, "update", "sketch")
        win.spans.wrap(srv.tuning, "tune_from_profiles", "retune")
    win.run(step)
    srv.tuning.tune_from_profiles = real_retune
    peak = memory_peak(torch, ctx.device)
    n_done = len(win.latencies)
    events = sum(len(stream[i % len(stream)]) for i in range(n_done))
    e2e = {"setup_s": setup_s, "events_per_s": events / win.seconds}
    program, locate_miss = program_run(initial, batches, profiles, inp)
    numbers = {"failed": float(win.failed), "locate_miss": locate_miss}
    numbers.update(check(ctx, inp, program))
    correct, checks = checks_with_limits(numbers, ctx.limits)
    return {"correct": correct and n_done > 0, "attempted": n_done,
            "failed": win.failed, "e2e": e2e, "checks": checks,
            "memory_peak_bytes": peak, "errors": win.errors,
            "readings": win.readings(
                "batch", {"retune": win.spans.calls.get("retune", 0)})}


def program_run(initial, batches, profiles, inp):
    """The program's run as plain values, and its located-position misses."""
    def counts_of(profs):
        return {kn: profs.counts[i] for i, kn in enumerate(profs.knobs)}

    out, miss, evals = [], 0.0, 0
    init = answer_of(initial, counts_of(profiles[0]) if profiles else None)
    for j, wl, rep in batches:
        miss += located_misses(wl, batch_parts(inp.stream[j]))
        d = None
        if rep.decision is not None:
            evals += 1
            dec = rep.decision
            keep = evals < len(profiles)
            d = answer_of(dec.result, counts_of(profiles[evals])
                          if keep else None)
            d.update(io_current=dec.io_current, rebuild_io=dec.rebuild_io,
                     switched=dec.switched)
        out.append({"stream_index": j, "tv": rep.tv, "decision": d})
    return {"initial": init, "batches": out}, miss


def located_misses(wl, parts) -> float:
    got = {p.kind: p for p in (wl.parts if wl.kind == "mixed" else (wl,))}
    miss = 0.0
    for op, (lo, hi) in parts.items():
        p = got.get(op)
        if p is None or p.positions.shape != lo.shape:
            miss += lo.shape[0]
            continue
        miss += float(np.count_nonzero(np.asarray(p.positions) != lo))
        if op != "point":
            miss += float(np.count_nonzero(np.asarray(p.hi_positions) != hi))
    return miss


def check(ctx, inp, program):
    from cambench.reference.online import OnlineReference, follow
    from cambench.reference.tune import knob_sizes

    sizes, _ = knob_sizes(inp)
    ref = OnlineReference(inp, sizes, ctx.device)
    return follow(ref, inp.warm, inp.stream, program)

