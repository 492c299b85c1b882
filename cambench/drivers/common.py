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
    """

    def __init__(self, ctx, torch, span_labels):
        self.ctx, self.torch = ctx, torch
        self.trace = bool(ctx.args.trace)
        self.span_labels = tuple(span_labels)
        self.spans = Spans(torch, ctx.device)
        self.kernels = KernelCalls()
        self.device_trace = DeviceTrace(torch)
        self.latencies, self.failed, self.errors = [], 0, []
        self.seconds = 0.0
        self.counted = 0              # steps after the traced part

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
        t0 = t_trace = time.perf_counter()
        i = 0
        while time.perf_counter() - t0 < self.ctx.args.seconds:
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
            else:
                self.counted += 1
        self.seconds = time.perf_counter() - t0
        if tracing:
            self.kernels.active = False
            self.device_trace.stop()
        if self.trace:
            self.device_trace.reduce(self.span_labels)
        self.spans.restore()
        self.kernels.restore()

    def readings(self, unit: str, extra_counts=None):
        if not self.trace:
            return None
        counts = {unit: self.counted}
        counts.update(extra_counts or {})
        untraced = self.latencies[len(self.latencies) - self.counted:]
        return Readings(self.spans, self.device_trace, self.kernels, counts,
                        self.ctx.device, untraced)


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
