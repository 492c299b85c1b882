"""Pieces both drivers use: the closed loop, the traced window, limits."""
from __future__ import annotations

import gc
import time

import numpy as np

from cambench.frozen.books import books_keys
from cambench.harness import DeviceTrace, KernelCalls, Readings, Spans
from cambench.work import WORK

#: Seconds of steady requests the device trace covers (at most a quarter
#: of the window), and the most steps it covers.
TRACE_SECONDS = 2.0
TRACE_STEPS = 32
#: Whole cycles of the cell's traffic, after its first, that an untraced
#: run's device trace covers where the cell reads an end-to-end metric
#: from the device trace.
E2E_CYCLES = 4


class Deployment:
    """The configuration file's deployment, and its key file from the seed
    (a rehearsal shrinks the keys and keeps the budget's ratio to them)."""

    def __init__(self, ctx):
        cfg = ctx.config
        self.n = int(cfg["keys"]) // ctx.shrink
        self.budget = float(cfg["memory_budget_bytes"]) * self.n \
            / int(cfg["keys"])
        self.c_ipp, self.page_bytes = cfg["items_per_page"], cfg["page_bytes"]
        self.num_pages = -(-self.n // self.c_ipp)
        self.family, self.grid = cfg["family"], tuple(cfg["knob_grid"])
        self.splits = tuple(cfg["splits"])
        self.policy = cfg["policy"]
        self.policies = None
        self.keys = books_keys(self.n, ctx.rng(0))


def settle(torch, device: str) -> None:
    """End set-up: wait for the device, collect set-up's garbage and freeze
    what survives, so that the collector's passes in the window walk only
    what the window itself allocates."""
    if device == "cuda":
        torch.cuda.synchronize()
    gc.collect()
    gc.freeze()


class Window:
    """A closed loop with one client: ``step(i)`` until ``seconds`` pass.

    In a traced run the first ``TRACE_SECONDS`` (at most ``TRACE_STEPS``
    steps) run under the profiler with the CAM kernels' calls captured; the
    spans restart after it, so their means cover only the untraced rest of
    the window.

    In an untraced run of a cell that reads an end-to-end metric from the
    device trace (``ctx.device_e2e``), steps ``cycle`` to ``cycle * (1 +
    E2E_CYCLES)`` run under the profiler: whole cycles of a traffic that
    repeats every ``cycle`` steps, so the same work in every run.  The
    profiler's start and its stop, which parses its events, take seconds:
    the window's clock stands still while they run, so the window still
    holds ``seconds`` of steps.
    """

    def __init__(self, ctx, torch, span_labels, cycle: int = 0):
        self.ctx, self.torch = ctx, torch
        self.trace = bool(ctx.args.trace)
        self.span_labels = tuple(span_labels)
        self.spans = Spans(torch, ctx.device)
        self.kernels = KernelCalls()
        self.device_trace = DeviceTrace(torch)
        self.cycle = int(cycle)
        self.e2e_trace = (DeviceTrace(torch) if not self.trace and cycle
                          and ctx.device_e2e else None)
        self.e2e_steps = range(0)     # the steps the e2e trace covers
        self.latencies, self.failed, self.errors = [], 0, []
        self.seconds = 0.0
        self.counted = 0              # steps after the traced part
        self.untraced_s = 0.0         # and their seconds

    def install_kernel_capture(self) -> None:
        from repro_torch.kernels import price_grid, profile_grid
        for mod, name in ((price_grid, "price_grid"),
                          (profile_grid, "profile_grid")):
            self.kernels.install(mod, name, WORK[name][0])

    def run(self, step) -> None:
        sync = (self.torch.cuda.synchronize if self.ctx.device == "cuda"
                else (lambda: None))
        tracing = self.trace
        if tracing:
            self.install_kernel_capture()
            self.kernels.active = True
            self.device_trace.start()
        e2e, e2e_on = self.e2e_trace, False
        e2e_end = self.cycle * (1 + E2E_CYCLES)
        t0 = t_trace = t_untraced = time.perf_counter()
        paused = 0.0
        i = 0
        while time.perf_counter() - t0 - paused < self.ctx.args.seconds:
            if e2e is not None and i == self.cycle:
                p0 = time.perf_counter()
                e2e.start()
                paused += time.perf_counter() - p0
                e2e_on = True
            s0 = time.perf_counter()
            try:
                step(i)
            except Exception as e:        # an answer that never comes
                self.failed += 1
                self.errors.append(f"{type(e).__name__}: {e}")
            sync()
            self.latencies.append(time.perf_counter() - s0)
            i += 1
            if tracing and (i >= TRACE_STEPS or time.perf_counter() - t_trace
                            >= min(TRACE_SECONDS, self.ctx.args.seconds / 4)):
                tracing = False
                self.kernels.active = False
                self.device_trace.stop()
                self.spans.seconds.clear()
                self.spans.calls.clear()
                self.counted = 0
                t_untraced = time.perf_counter()
            else:
                self.counted += 1
            if e2e_on and i == e2e_end:
                p0 = time.perf_counter()
                e2e.stop()
                paused += time.perf_counter() - p0
                e2e_on = False
        t_end = time.perf_counter()
        self.seconds = t_end - t0 - paused
        self.untraced_s = t_end - t_untraced
        if tracing:
            self.kernels.active = False
            self.device_trace.stop()
        if e2e_on:
            e2e.stop()
        if self.trace:
            self.device_trace.reduce(self.span_labels)
        if e2e is not None and i > self.cycle:
            self.e2e_steps = range(self.cycle, min(i, e2e_end))
            e2e.reduce(self.span_labels)
        self.spans.restore()
        self.kernels.restore()

    def untraced_steps(self) -> range:
        """The steps after a traced run's traced part."""
        n = len(self.latencies)
        return range(n - self.counted, n)

    def readings(self, unit: str, extra_counts=None):
        if not self.trace:
            return None
        counts = {unit: self.counted}
        counts.update(extra_counts or {})
        untraced = self.latencies[len(self.latencies) - self.counted:]
        return Readings(self.spans, self.device_trace, self.kernels, counts,
                        self.ctx.device, untraced, self.untraced_s)

    def e2e_readings(self, counts):
        """What an end-to-end metric's reader reads from the untraced run's
        device trace over ``e2e_steps`` (None without one)."""
        if not self.e2e_steps:
            return None
        return Readings(self.spans, self.e2e_trace, self.kernels, counts,
                        self.ctx.device, [])


def checks_with_limits(numbers: dict, limits: dict):
    """(correct, {name: (value, limit)}): every number within its limit."""
    out, ok = {}, True
    for name, value in numbers.items():
        limit = limits[name]
        value = float(value)
        out[name] = (value, limit)
        ok = ok and bool(np.isfinite(value)) and value <= limit
    return ok, out


def memory_peak(torch, device: str) -> int:
    if device == "cuda":
        torch.cuda.synchronize()
        return int(torch.cuda.max_memory_allocated())
    return 0
