"""Tune requests from one client: an index advisor asking for a configuration.

Set-up makes the key file and a pool of point workloads from ``--seed``,
builds what the family's size model needs (four PGM builds for the
power-law fit; every budget-feasible RMI), and serves one warm request.
Each request of the window takes the next pool entry's raw query keys,
locates them (``Workload.from_keys``) and runs ``TuningSession.tune``,
ending in the host-side ``TuneResult``.

The check: a sample of pool entries drawn from the seed is worked out
again by ``cambench.reference`` (float64) and compared with every request
of those entries — located positions, each candidate's profile and E[DAC],
every priced cell's capacity, hit rate and I/O, and the chosen cell's
I/O against the least the reference finds.
"""
from __future__ import annotations

import contextlib

import numpy as np

from cambench.drivers.common import (Deployment, Window, checks_with_limits,
                                     memory_peak, settle)
from cambench.frozen.workloads import WorkloadSpec, point_positions
from cambench.harness import process_age

SPANS = ("locate", "tune", "profile", "price")


class Inputs(Deployment):
    """Everything the benchmark makes from the seed (shared with the
    reference and the control, never with the program's outputs)."""

    def __init__(self, ctx):
        super().__init__(ctx)
        tr = ctx.traffic
        self.policies = tr.get("policies")
        q = max(1000, int(tr["queries"]) // ctx.shrink)
        self.pool = []
        for i in range(int(tr["pool"])):
            spec = WorkloadSpec(tr["mixture"], int(tr["n_hotspots"]),
                                float(tr["hotspot_frac"]),
                                float(tr["zipf_a"]), seed=[ctx.seed, 1, i])
            pos = point_positions(self.n, q, spec)
            self.pool.append((pos, self.keys[pos]))
        # the pool entries the check compares, drawn from the seed
        k = min(int(tr["check_pool"]), len(self.pool))
        pick = ctx.rng(2).choice(len(self.pool), size=k, replace=False)
        self.checked = sorted(pick.tolist())


def run(ctx):
    import torch
    from repro_torch.core.cam import CamGeometry
    from repro_torch.core.session import System
    from repro_torch.core.workload import Workload
    from repro_torch.tuning.session import (PGMBuilder, RMIBuilder,
                                            TuningSession)

    inp = Inputs(ctx)
    system = System(CamGeometry(c_ipp=inp.c_ipp, page_bytes=inp.page_bytes),
                    inp.budget, inp.policy, torch_device=ctx.device)
    knob = "eps" if inp.family == "pgm" else "branch"
    builder = (PGMBuilder if inp.family == "pgm" else RMIBuilder)(inp.keys)
    space = builder.knob_space({knob: inp.grid})
    size = builder.size_model()
    for pt in space.points():        # the size model's builds, up front
        if system.capacity_for(size(**pt)) >= 1 and inp.family == "rmi":
            builder.build(pt)
    ts = TuningSession(system, splits=inp.splits)
    policies = tuple(inp.policies) if inp.policies else None

    # Only the checked entries' outputs are kept: every object the harness
    # holds on to lengthens the collector's full passes inside the window.
    checked = set(inp.checked)
    answers = {}                     # checked entry -> first request's outputs
    results = []                     # (checked entry, TuneResult)
    first = {"profiles": None}
    real_profiles = ts.cost.grid_profiles

    def keep_profiles(*a, **kw):
        out = real_profiles(*a, **kw)
        first["profiles"] = out
        return out

    ts.cost.grid_profiles = keep_profiles
    win = Window(ctx, torch, SPANS)

    def request(i: int, record: bool = True):
        entry = i % len(inp.pool)
        qk = inp.pool[entry][1].view()   # a fresh array object a request
        with win.spans.span("locate") if win.trace else \
                contextlib.nullcontext():
            wl = Workload.from_keys(inp.keys, qk)
        first["profiles"] = None
        with win.spans.span("tune") if win.trace else \
                contextlib.nullcontext():
            res = ts.tune(builder, wl, overrides={knob: inp.grid},
                          policies=policies)
        if record and entry in checked:
            results.append((entry, res))
            if entry not in answers:
                profs = first["profiles"]
                answers[entry] = (wl.positions, {
                    kn: profs.counts[i] for i, kn in enumerate(profs.knobs)})

    request(0, record=False)         # warm: the cell's own shapes
    settle(torch, ctx.device)
    setup_s = process_age()
    if win.trace:
        win.spans.wrap(ts.cost, "grid_profiles", "profile")
        win.spans.wrap(ts.cost.engine, "price", "price")
    win.run(request)
    ts.cost.grid_profiles = real_profiles
    peak = memory_peak(torch, ctx.device)
    n_done = len(win.latencies)
    e2e = {"setup_s": setup_s, "tune_s": win.seconds / max(n_done, 1)}
    del ts, builder, system
    numbers = compare(ctx, inp, answers,
                      [(e, answer_of(r)) for e, r in results], win.failed)
    correct, checks = checks_with_limits(numbers, ctx.limits)
    return {"correct": correct and n_done > 0, "attempted": n_done,
            "failed": win.failed, "e2e": e2e, "checks": checks,
            "memory_peak_bytes": peak, "errors": win.errors,
            "readings": win.readings("request")}


# ---------------------------------------------------------------------------
# The check
# ---------------------------------------------------------------------------

def answer_of(res) -> dict:
    """A TuneResult as plain values: {"cells": {(knob key, capacity): (hit
    rate, io, dac)}, "est_io": the chosen cell's io}."""
    return {"cells": {(kn, e.capacity_pages): (e.hit_rate, e.io, e.dac)
                      for kn, entries in res.table.items() for e in entries},
            "est_io": res.est_io}


def compare(ctx, inp, answers, results, failed: int, reference=None):
    """The compared numbers of ``answers`` ({entry: (located positions,
    {knob: counts})}, each checked entry's first request) and ``results``
    ((entry, ``answer_of``) of every request of them) against the
    reference."""
    from cambench.reference.tune import reference_entries

    ref = reference if reference is not None else reference_entries(
        ctx, inp, sorted(answers))
    nums = {"failed": float(failed), "locate_miss": 0.0, "cap_miss": 0.0,
            "profile_err": 0.0, "dac_err": 0.0, "hit_err": 0.0,
            "io_err": 0.0, "best_io_err": 0.0}
    for entry, (positions, profiles) in answers.items():
        r = ref[entry]
        truth = inp.pool[entry][0]
        positions = np.asarray(positions)
        nums["locate_miss"] += float(
            np.count_nonzero(positions != truth)
            if positions.shape == truth.shape else truth.shape[0])
        nums["profile_err"] = max(nums["profile_err"],
                                  profile_err(profiles, r))
    for entry, res in results:
        r = ref[entry]
        got = res["cells"]
        nums["cap_miss"] += float(len(set(got) ^ set(r["cells"])))
        for key, (h, io, dac) in got.items():
            if key not in r["cells"]:
                continue
            rh, rio, rdac = r["cells"][key]
            nums["hit_err"] = max(nums["hit_err"], abs(h - rh))
            nums["io_err"] = max(nums["io_err"], abs(io - rio) / rio)
            nums["dac_err"] = max(nums["dac_err"], abs(dac - rdac) / rdac)
        est = res["est_io"]
        best = min(v[1] for v in r["cells"].values())
        nums["best_io_err"] = max(nums["best_io_err"],
                                  abs(est - best) / best)
    if not answers:
        nums["locate_miss"] = np.inf
    return nums


def profile_err(counts, r) -> float:
    """Worst row of max |counts - reference| over the reference row's peak."""
    worst = 0.0 if set(counts) == set(r["counts"]) else float("inf")
    for kn, row in counts.items():
        ref = r["counts"].get(kn)
        if ref is None:
            continue
        got = row.to(ref.device, ref.dtype)
        worst = max(worst, float((got - ref).abs().max() / ref.abs().max()))
    return worst
