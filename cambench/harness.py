"""What every driver shares: spans, the device trace, kernel-call capture,
the result line.

Spans and the trace exist only in a traced run (``--trace 1``).  A span
wraps a method of the program at run time, ends in a device synchronize,
and is also a ``torch.profiler.record_function`` so the trace can say
what the host was doing while the device sat idle.
"""
from __future__ import annotations

import contextlib
import json
import os
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

#: Top-level module names that may not be loaded once the window has closed.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")


def process_age() -> float:
    """Seconds since this process started (Linux ``/proc``)."""
    ticks = os.sysconf("SC_CLK_TCK")
    with open("/proc/self/stat") as f:
        start = float(f.read().rsplit(")", 1)[1].split()[19]) / ticks
    with open("/proc/uptime") as f:
        return float(f.read().split()[0]) - start


def forbidden_modules():
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN_MODULES))


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


class Spans:
    """Host time and calls of wrapped program methods, by label."""

    def __init__(self, torch, device):
        self.torch = torch
        self.sync = (torch.cuda.synchronize if device == "cuda"
                     else (lambda: None))
        self.seconds = defaultdict(float)
        self.calls = defaultdict(int)
        self._undo = []

    @contextlib.contextmanager
    def span(self, label: str):
        t0 = time.perf_counter()
        try:
            with self.torch.profiler.record_function(label):
                yield
                self.sync()
        finally:
            self.seconds[label] += time.perf_counter() - t0
            self.calls[label] += 1

    def wrap(self, owner, name: str, label: str) -> None:
        real = getattr(owner, name)
        spans = self

        def timed(*a, **kw):
            with spans.span(label):
                return real(*a, **kw)

        setattr(owner, name, timed)
        self._undo.append(lambda: setattr(owner, name, real))

    def restore(self) -> None:
        while self._undo:
            self._undo.pop()()

    def mean_ms(self, label: str, per: int):
        """Mean span milliseconds per unit of work (None without spans)."""
        if not self.calls.get(label) or per <= 0:
            return None
        return 1e3 * self.seconds[label] / per


class KernelCalls:
    """Arguments of the CAM kernels' wrappers while ``active`` (a traced
    window): the roofline readers count their work afterwards."""

    def __init__(self):
        self.active = False
        self.calls = defaultdict(list)
        self._undo = []

    def install(self, module, name: str, normalize) -> None:
        real = getattr(module, name)
        rec = self

        def capture(*a, **kw):
            if rec.active:
                rec.calls[name].append(normalize(a, kw))
            return real(*a, **kw)

        setattr(module, name, capture)
        self._undo.append(lambda: setattr(module, name, real))

    def restore(self) -> None:
        while self._undo:
            self._undo.pop()()


class DeviceTrace:
    """A ``torch.profiler`` window over a few seconds of steady requests.

    After ``stop``: ``window_s`` (wall length), ``busy_s`` (union of device
    activity), device seconds by kernel name, and idle gaps labelled by the
    innermost harness span the host was in.
    """

    def __init__(self, torch):
        self.torch = torch
        self.prof = None
        self.window_s = 0.0
        self.busy_s = 0.0
        self.by_name = {}
        self.idle_by_host = {}

    def start(self) -> None:
        acts = [self.torch.profiler.ProfilerActivity.CPU]
        if self.torch.cuda.is_available():
            acts.append(self.torch.profiler.ProfilerActivity.CUDA)
        self.prof = self.torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        if self.torch.cuda.is_available():
            self.torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self._t0
        self.prof.__exit__(None, None, None)

    def reduce(self, span_labels) -> None:
        """Read the stopped window's events (after the run's window)."""
        device, spans = [], []
        cuda = self.torch.autograd.DeviceType.CUDA
        for e in self.prof.events():
            tr = e.time_range
            if e.name in span_labels:
                # a span's mirror on the device timeline is no device work
                if e.device_type != cuda:
                    spans.append((tr.start, tr.end, e.name))
            elif e.device_type == cuda:
                device.append((tr.start, tr.end, e.name))
        self.prof = None
        by_name = defaultdict(float)
        for a, b, name in device:
            by_name[name] += (b - a) * 1e-6
        self.by_name = dict(by_name)
        device.sort()
        busy, gaps, end = 0.0, [], None
        for a, b, _ in device:
            if end is None or a > end:
                if end is not None:
                    gaps.append((end, a))
                busy += b - a
                end = b
            elif b > end:
                busy += b - end
                end = b
        self.busy_s = busy * 1e-6
        if device and spans:        # idle before the first and after the last
            gaps.append((min(a for a, _, _ in spans), device[0][0]))
            gaps.append((end, max(b for _, b, _ in spans)))
        idle = defaultdict(float)
        for g0, g1 in gaps:
            if g1 <= g0:
                continue
            mid = 0.5 * (g0 + g1)
            inside = [(b - a, name) for a, b, name in spans if a <= mid <= b]
            label = min(inside)[1] if inside else "harness"
            idle[label] += (g1 - g0) * 1e-6
        self.idle_by_host = dict(idle)

    def kernel_seconds(self, markers) -> float:
        return sum(s for name, s in self.by_name.items()
                   if any(m in name for m in markers))

    def breakdown(self):
        top = sorted(self.by_name.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n, s] for n, s in top],
                "idle_gaps": [[n, s] for n, s in gaps]}


class Readings:
    """What a per-layer metric's reader can read after a traced run."""

    def __init__(self, spans, trace, kernels, counts, device, latencies):
        self.spans = spans
        self.trace = trace
        self.kernels = kernels
        self.counts = counts          # units of work: requests, batches, ...
        self.device = device
        self.latencies = latencies    # seconds a step, after the trace

    def latency_p90_ms(self):
        """90th percentile of the steps' latencies after the traced part."""
        if not self.latencies:
            return None
        import numpy as np
        return 1e3 * float(np.percentile(
            np.asarray(self.latencies, np.float64), 90))

    def span_ms(self, label: str, per: str):
        return self.spans.mean_ms(label, self.counts.get(per, 0))

    def idle_pct(self):
        if self.device != "cuda" or self.trace.busy_s <= 0:
            return None
        return 100.0 * (1.0 - self.trace.busy_s / self.trace.window_s)

    def roofline_pct(self, kernel: str):
        """Least time over device time of the wrapper's traced calls."""
        from cambench.work import KERNELS, WORK, least_seconds

        calls = self.kernels.calls.get(kernel)
        dev_s = self.trace.kernel_seconds(KERNELS[kernel])
        if not calls or self.device != "cuda" or dev_s <= 0:
            return None
        work = WORK[kernel][1]
        least = sum(least_seconds(*work(c)) for c in calls)
        return 100.0 * least / dev_s


def read_metric(name: str, readings: Readings):
    """Run ``metrics/<name>.py``'s ``read`` (None: nothing to read)."""
    import importlib.util

    path = ROOT / "cambench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "cambench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(readings)
