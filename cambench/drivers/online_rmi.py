"""An index service over a disk-resident RMI retuning online.

``drivers/online.py``'s closed-loop replay of the drifting op log, with the
RMI family: the served session tunes the branch factor (the configuration's
``knob_grid``) and the buffer split.  Set-up makes the key file and the op
log from ``--seed``, builds the RMI of every branch once (one
``RMIBuilder`` serves the throwaway session that warms every op mix and
the served session), then starts the served session on the warm segments.
Each step compiles the next batch and ingests it: every candidate routes
the batch's point keys and both keys of each range, profiles its points
with ``profile_grid`` and its ranges by difference arrays on the card, and
shares one sorted-probe profile.  An untraced run also traces cycles 2 to 5
of the stream on the device, for the chip time its events cost.

The check replays the run through ``cambench.reference.online_rmi``: every
batch's located positions and TV distance, every evaluation and switch,
each retune's priced table and choice, and the window profiles of the
first evaluations.

    python3 -m cambench.drivers.online_rmi --workload rmi.online-drift \\
        --seeds 5 6 7

runs the cell's control (``cambench.control``'s lines, for this driver).
"""
from __future__ import annotations

import contextlib
import sys
import time

import numpy as np

from cambench.drivers.common import (Window, checks_with_limits, memory_peak,
                                     settle)
from cambench.drivers.online import (SPANS, Inputs, program_run,
                                     trace_events)
from cambench.harness import process_age


def require_range_routing(ctx) -> None:
    """Stop at once, before any build, where the program cannot profile an
    RMI's range scans (it would skip every candidate on the first batch)."""
    from repro_torch.core.cam import CamGeometry
    from repro_torch.core.session import UnsupportedWorkloadError
    from repro_torch.index.adapters import RMIAdapter
    from repro_torch.serving.trace import TraceEvent, compile_events

    keys = np.arange(0, 1 << 16, 4, dtype=np.uint64)
    wl = compile_events([TraceEvent("range", lo_key=8.0, hi_key=4096.0)],
                        keys)
    try:
        RMIAdapter.build(keys, 4).page_ref_profile(
            wl, CamGeometry(c_ipp=64, page_bytes=4096), device="cpu")
    except UnsupportedWorkloadError as e:
        raise SystemExit(f"{ctx.args.workload}: this program cannot profile "
                         f"an RMI's range scans ({e})")


def run(ctx):
    import torch
    from repro_torch.core.cam import CamGeometry
    from repro_torch.core.session import System
    from repro_torch.serving import ServingConfig, ServingSession
    from repro_torch.serving.trace import compile_events
    from repro_torch.tuning.session import RMIBuilder, TuningSession

    require_range_routing(ctx)
    inp = Inputs(ctx)
    system = System(CamGeometry(c_ipp=inp.c_ipp, page_bytes=inp.page_bytes),
                    inp.budget, inp.policy, torch_device=ctx.device)
    builder = RMIBuilder(inp.keys)
    sv = inp.serving
    scfg = ServingConfig(batch_size=inp.batch_size,
                         window_chunks=sv["window_chunks"],
                         page_bins=sv["page_bins"],
                         drift_threshold=sv["drift_threshold"],
                         hysteresis=sv["hysteresis"],
                         cooldown_batches=sv["cooldown_batches"],
                         horizon_queries=sv["horizon_queries"])
    overrides = {"branch": inp.grid}
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

    win = Window(ctx, torch, SPANS, cycle=len(stream))
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

    def events(steps):
        return sum(len(stream[i % len(stream)]) for i in steps)

    e2e = {"setup_s": setup_s}
    t_check = time.perf_counter()
    program, locate_miss = program_run(initial, batches, profiles, inp)
    numbers = {"failed": float(win.failed), "locate_miss": locate_miss}
    numbers.update(check(ctx, inp, program))
    correct, checks = checks_with_limits(numbers, ctx.limits)
    phases = {"setup_s": setup_s, "window_s": win.seconds,
              "check_s": time.perf_counter() - t_check}
    return {"correct": correct and n_done > 0, "attempted": n_done,
            "failed": win.failed, "e2e": e2e, "checks": checks,
            "phases": phases,
            "memory_peak_bytes": peak, "errors": win.errors,
            "readings": win.readings(
                "batch", {"retune": win.spans.calls.get("retune", 0),
                          "event": events(win.untraced_steps())}),
            "e2e_readings": win.e2e_readings(
                {"batch": len(win.e2e_steps),
                 "event": events(win.e2e_steps)})}


def reference(ctx, inp):
    """The float64 RMI reference of the cell's inputs (the frozen builds)."""
    from cambench.reference.online_rmi import RMIOnlineReference
    from cambench.reference.tune import knob_sizes

    sizes, rmis = knob_sizes(inp)
    return RMIOnlineReference(inp, sizes, rmis, ctx.device)


def check(ctx, inp, program, ref=None):
    """The compared numbers of a program run (``ref``: the float64
    reference, built here unless given)."""
    from cambench.reference.online import follow

    ref = reference(ctx, inp) if ref is None else ref
    return follow(ref, inp.warm, inp.stream, program)


def control(ctx, batches: int = 120):
    """The reference's own serving run at the lower precision, judged by
    the float64 reference following it (about a window's batches)."""
    import torch

    from cambench.reference.online import run_alone
    from cambench.reference.online_rmi import RMIOnlineReference

    inp = Inputs(ctx)
    ref = reference(ctx, inp)
    low = RMIOnlineReference(inp, ref.sizes, ref.rmis, ctx.device,
                             profile_dtype=torch.float32,
                             price_dtype=torch.bfloat16,
                             summary_dtype=np.float32)
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        program = run_alone(low, inp.warm, inp.stream, batches, 2)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    numbers = {"failed": 0.0, "locate_miss": 0.0}
    numbers.update(check(ctx, inp, program, ref))
    return numbers


def main(argv=None) -> int:
    from cambench import control as controls

    controls.CONTROLS.setdefault("online_rmi", control)
    return controls.main(argv)


if __name__ == "__main__":
    sys.exit(main())
