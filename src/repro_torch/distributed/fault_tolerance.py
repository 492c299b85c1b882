"""Fault-tolerant training supervision: checkpoint/restart, failure
detection, straggler mitigation.

Mirrors ``repro/distributed/fault_tolerance.py``.  The ``Supervisor`` wraps
any step callable.  On a (real or injected) failure it restores the latest
checkpoint onto the state's device and replays the data pipeline to the
restored step — the data pipeline is a pure function of the step index,
so replay is exact.  Straggler mitigation tracks the step times and flags
steps exceeding ``straggler_factor``x the median of the last 50; the
mitigation hook is pluggable.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.distributed import checkpoint as ckpt_mod

__all__ = ["SimulatedFailure", "FailureInjector", "StragglerStats",
           "Supervisor"]


class SimulatedFailure(RuntimeError):
    """Stands in for a node loss / preemption in tests."""


@dataclasses.dataclass
class FailureInjector:
    """Raises SimulatedFailure at the given global steps (once each)."""

    fail_at: tuple = ()
    delays: Dict[int, float] = dataclasses.field(default_factory=dict)
    _fired: set = dataclasses.field(default_factory=set)

    def check(self, step: int):
        if step in self.delays:
            time.sleep(self.delays[step])
        if step in self.fail_at and step not in self._fired:
            self._fired.add(step)
            raise SimulatedFailure(f"injected failure at step {step}")


@dataclasses.dataclass
class StragglerStats:
    times: List[float] = dataclasses.field(default_factory=list)
    flagged: List[int] = dataclasses.field(default_factory=list)

    def observe(self, step: int, seconds: float, factor: float) -> bool:
        self.times.append(seconds)
        if len(self.times) >= 5:
            med = sorted(self.times[-50:])[len(self.times[-50:]) // 2]
            if seconds > factor * med:
                self.flagged.append(step)
                return True
        return False


def _device_of(tree) -> torch.device:
    """The device of the first tensor leaf of ``tree``, or None."""
    if isinstance(tree, dict):
        for v in tree.values():
            dev = _device_of(v)
            if dev is not None:
                return dev
        return None
    return tree.device if isinstance(tree, torch.Tensor) else None


class Supervisor:
    """Run a step function with checkpoint/restart + straggler tracking."""

    def __init__(self, step_fn: Callable, state: Dict[str, Any],
                 batch_for_step: Callable[[int], Any], ckpt_dir: str,
                 ckpt_every: int = 50, max_restarts: int = 5,
                 straggler_factor: float = 3.0,
                 injector: Optional[FailureInjector] = None,
                 on_straggler: Optional[Callable[[int], None]] = None):
        self.step_fn = step_fn
        self.state = state                 # {"params":..., "opt_state":...}
        self.device = _device_of(state) or torch.device("cpu")
        self.batch_for_step = batch_for_step
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        self.max_restarts = max_restarts
        self.injector = injector
        self.on_straggler = on_straggler
        self.straggler_factor = straggler_factor
        self.stats = StragglerStats()
        self.restarts = 0
        self.start_step = 0

    def _save(self, step: int):
        ckpt_mod.save_checkpoint(self.ckpt_dir, step, self.state)

    def _restore(self) -> int:
        """Put the latest checkpoint's trees on the state's device, in the
        dtypes they were saved in."""
        step, trees = ckpt_mod.restore_checkpoint(self.ckpt_dir,
                                                  device=self.device)
        self.state = trees
        return step

    def run(self, num_steps: int) -> Dict[str, Any]:
        step = self.start_step
        if ckpt_mod.latest_step(self.ckpt_dir) is not None:
            step = self._restore()          # auto-resume
        if step == 0:
            self._save(0)
        losses = []
        while step < num_steps:
            t0 = time.perf_counter()
            try:
                if self.injector:
                    self.injector.check(step)
                batch = self.batch_for_step(step)
                self.state, metrics = self.step_fn(self.state, batch)
            except SimulatedFailure:
                self.restarts += 1
                if self.restarts > self.max_restarts:
                    raise
                step = self._restore()      # roll back + replay pipeline
                continue
            # float() waits for the device, so dt covers the step's work
            losses.append(float(metrics.get("loss", 0.0)))
            dt = time.perf_counter() - t0
            if self.stats.observe(step, dt, self.straggler_factor):
                if self.on_straggler:
                    self.on_straggler(step)
            step += 1
            if step % self.ckpt_every == 0:
                self._save(step)
        self._save(num_steps)
        return {"losses": losses, "restarts": self.restarts,
                "stragglers": list(self.stats.flagged), "final_step": step}
