"""Serving-loop drift benchmark: adaptive vs static vs oracle retuning.

The port's twin of the JAX package's ``benchmarks/bench_serving_drift.py``:
the same drift script, sizes, arms, accounting and gates, run through
``repro_torch`` on a torch device.

A piecewise-drifting synthetic trace (hot-set moves, range widths widen,
op mix shifts — see the segment table below) streams through four arms:

* ``static``      — tuned once on the warmup prefix, never touched again;
* ``adaptive``    — :class:`ServingSession` with the rebuild-cost gate ON:
                    retunes from the live sketch on drift, switches only
                    when predicted steady-state savings over the horizon
                    repay the modeled rebuild I/O;
* ``every_drift`` — the same loop with the gate OFF: every drift trigger
                    redeploys the retuned best (the rebuild-happy baseline);
* ``oracle``      — retuned offline on each segment's full workload at the
                    (unknowable in production) segment boundaries.

Accounting charges each arm the model-predicted I/O of its ACTIVE
configuration on each span of the stream it was active for, plus the
modeled rebuild I/O of every switch.  Two gates hold (the run fails
otherwise): the adaptive arm's total I/O is >= 1.2x lower than static, and
it issues STRICTLY fewer rebuilds than every_drift.  The record is printed
as the last line of standard output (JSON).

    PYTHONPATH=src python -m repro_torch.launch.bench_serving_drift --smoke

Runs on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import dataclasses
import json
import time

import numpy as np

from repro_torch.core.cam import CamGeometry
from repro_torch.core.session import DEFAULT_TORCH_DEVICE, System
from repro_torch.core.workload import Workload
from repro_torch.data.datasets import make_dataset
from repro_torch.serving import (ServingConfig, ServingSession,
                                 synthetic_drifting_trace)
from repro_torch.serving.trace import compile_events, iter_batches
from repro_torch.tuning.session import PGMBuilder, TuningSession

GEOM = CamGeometry(c_ipp=256, page_bytes=4096)
BUFFER_KB = 512
EPS_GRID = (8, 16, 32, 64, 128, 256, 512)


def emit(name: str, us_per_call: float, derived: str):
    print(f"{name},{us_per_call:.1f},{derived}", flush=True)


def segments(scale: int):
    """The drift script.  Segment 2 is a short 'flash' — a hot-set blip
    that reverts: it moves enough probability mass to trigger TV drift,
    but the optimal knob barely moves, so the rebuild gate should refuse
    it while the gate-off arm rebuilds; segments 4-5 are genuine regime
    changes the adaptive arm must follow."""
    return [
        # 0: warmup — point-heavy, tight hot set, narrow ranges
        {"events": 8 * scale, "mix": (0.8, 0.2, 0.0), "hot_center": 0.2,
         "hot_width": 0.05, "hot_frac": 0.95, "range_width": 16},
        # 1: same regime continues (served steady state)
        {"events": 4 * scale, "mix": (0.8, 0.2, 0.0), "hot_center": 0.2,
         "hot_width": 0.05, "hot_frac": 0.95, "range_width": 16},
        # 2: FLASH — hot set blips elsewhere, everything else unchanged
        {"events": 2 * scale, "mix": (0.8, 0.2, 0.0), "hot_center": 0.6,
         "hot_width": 0.05, "hot_frac": 0.95, "range_width": 16},
        # 3: blip reverts
        {"events": 3 * scale, "mix": (0.8, 0.2, 0.0), "hot_center": 0.2,
         "hot_width": 0.05, "hot_frac": 0.95, "range_width": 16},
        # 4: REGIME CHANGE — range-heavy, wide scans, broad warm set
        {"events": 8 * scale, "mix": (0.1, 0.8, 0.1), "hot_center": 0.75,
         "hot_width": 0.4, "hot_frac": 0.9, "range_width": 2048},
        # 5: second regime — sorted sweeps join in
        {"events": 6 * scale, "mix": (0.2, 0.4, 0.4), "hot_center": 0.5,
         "hot_width": 0.6, "hot_frac": 0.9, "range_width": 1024,
         "sorted_run": 64},
    ]


def serving_config(scale: int, smoke: bool) -> ServingConfig:
    return ServingConfig(batch_size=scale, window_chunks=4,
                         drift_threshold=0.12, hysteresis=0.04,
                         cooldown_batches=1,
                         horizon_queries=4_000 if smoke else 30_000)


def _price(tuning: TuningSession, builder, pt, size, capacity,
           wl: Workload) -> float:
    """Model-predicted I/O/query of ONE (knob, capacity) on ``wl``."""
    cand = builder.candidate(pt, size)
    profs = tuning.cost.grid_profiles([cand], wl)
    h, _ = tuning.cost.solve_profiles(profs, np.asarray([capacity]))
    return float((1.0 - h[0]) * profs.dacs[0])


def _rebuild_io(system: System, n: int, size_bytes: float,
                capacity: int, distinct: float) -> float:
    geom = system.geom
    return float(geom.num_pages(n) + np.ceil(size_bytes / geom.page_bytes)
                 + min(float(capacity), distinct))


def _spanify(configs, batch_wls):
    """Group consecutive batches under the same active config."""
    spans = []
    for cfg, wl in zip(configs, batch_wls):
        if spans and spans[-1][0] == cfg:
            spans[-1][1].append(wl)
        else:
            spans.append((cfg, [wl]))
    return spans


def serve_arm(keys, system, builder, cfg: ServingConfig, warmup,
              stream_batches, on_session=None):
    """One :class:`ServingSession` arm over the stream: returns the
    session, its (config, batches) spans and its rebuild I/O.
    ``on_session`` sees the session before its first batch (a caller's
    instrumentation hook)."""
    tuning = TuningSession(system)
    srv = ServingSession(tuning, builder, keys, config=cfg,
                         overrides={"eps": EPS_GRID})
    if on_session is not None:
        on_session(srv)
    srv.start(warmup)
    configs, batch_wls, rebuild_cost = [], [], 0.0
    for batch in stream_batches:
        wl = compile_events(batch, keys)
        report = srv.ingest(wl, ts=batch[-1].ts)
        if report.decision is not None and report.decision.switched:
            rebuild_cost += report.decision.rebuild_io
        configs.append(({"eps": srv.current.best_knob},
                        srv.current.capacity_pages))
        batch_wls.append(wl)
    return srv, _spanify(configs, batch_wls), rebuild_cost


def charge(tuning: TuningSession, builder, spans) -> float:
    """Model-predicted I/O of every span under its active config."""
    size_model = builder.size_model()
    total = 0.0
    for (pt, cap), wls in spans:
        wl = wls[0] if len(wls) == 1 else Workload.concat(*wls)
        total += wl.n_queries * _price(tuning, builder, pt,
                                       float(size_model(**pt)), cap, wl)
    return total


def decisions(srv: ServingSession):
    """The retune decisions of one arm, as plain values."""
    return [{"ts": d.ts, "tv": d.tv, "io_current": d.io_current,
             "io_candidate": d.io_candidate, "rebuild_io": d.rebuild_io,
             "switched": d.switched, "from_knob": d.from_knob,
             "to_knob": d.to_knob,
             "dac": max(e.dac for e in d.result.estimates.values())}
            for d in srv.decisions]


def measure(smoke: bool = False, seed: int = 0,
            torch_device: str = DEFAULT_TORCH_DEVICE) -> dict:
    """All four arms; the record with its gates (not asserted here)."""
    scale = 384 if smoke else 2048
    n = 50_000 if smoke else 400_000
    keys = make_dataset("books", n, seed=1)
    system = System(GEOM, memory_budget_bytes=BUFFER_KB << 10, policy="lru",
                    torch_device=torch_device)
    tuning = TuningSession(system)
    builder = PGMBuilder(keys)
    size_of = lambda pt: float(builder.size_model()(**pt))  # noqa: E731

    segs = segments(scale)
    events = synthetic_drifting_trace(keys, segs, seed=seed)
    warmup_n = segs[0]["events"]
    warmup, stream = events[:warmup_n], events[warmup_n:]
    scfg = serving_config(scale, smoke)
    batches = list(iter_batches(stream, scfg.batch_size))

    # ---- adaptive + every_drift (same stream, gate on/off) ---------------
    t0 = time.perf_counter()
    srv_a, spans_a, rb_a = serve_arm(keys, system, builder, scfg, warmup,
                                     batches)
    adaptive_seconds = time.perf_counter() - t0
    srv_e, spans_e, rb_e = serve_arm(
        keys, system, builder, dataclasses.replace(scfg, rebuild_gate=False),
        warmup, batches)

    # ---- static: the adaptive arm's initial config, frozen ---------------
    static_spans = [(spans_a[0][0], [wl for _, wls in spans_a
                                    for wl in wls])]

    # ---- oracle: offline retune on each segment's true workload ----------
    seg_groups, i = [], 0
    for seg in segs[1:]:
        k = int(np.ceil(seg["events"] / scfg.batch_size))
        seg_groups.append(batches[i:i + k])
        i += k
    oracle_spans, oracle_rb, oracle_rebuilds, prev = [], 0.0, 0, None
    for group in seg_groups:
        if not group:
            continue
        seg_wls = [compile_events(b, keys) for b in group]
        res = tuning.tune(builder, Workload.concat(*seg_wls),
                          overrides={"eps": EPS_GRID})
        cfg = ({"eps": res.best_knob}, res.capacity_pages)
        if prev is not None and cfg != prev:
            est = res.estimates[res.best_knob]
            oracle_rb += _rebuild_io(system, n, size_of(cfg[0]),
                                     res.capacity_pages, est.distinct_pages)
            oracle_rebuilds += 1
        prev = cfg
        oracle_spans.append((cfg, seg_wls))

    total_q = sum(wl.n_queries for _, wls in spans_a for wl in wls)
    arms = {}
    for name, spans, rb, rebuilds, extra in [
            ("static", static_spans, 0.0, 0, {}),
            ("adaptive", spans_a, rb_a, srv_a.stats.rebuilds,
             {"stats": dataclasses.asdict(srv_a.stats),
              "decisions": decisions(srv_a),
              "loop_seconds": adaptive_seconds}),
            ("every_drift", spans_e, rb_e, srv_e.stats.rebuilds,
             {"stats": dataclasses.asdict(srv_e.stats),
              "decisions": decisions(srv_e)}),
            ("oracle", oracle_spans, oracle_rb, oracle_rebuilds,
             {"configs": [cfg for cfg, _ in oracle_spans]})]:
        serve_io = charge(tuning, builder, spans)
        arms[name] = {"serve_io": serve_io, "rebuild_io": rb,
                      "total_io": serve_io + rb,
                      "io_per_query": (serve_io + rb) / total_q,
                      "rebuilds": rebuilds, **extra}
        emit(f"serving_drift/{name}", 1e6 * arms[name]["io_per_query"],
             f"total_io={arms[name]['total_io']:.0f} rebuilds={rebuilds}")

    ratio = arms["static"]["total_io"] / arms["adaptive"]["total_io"]
    record = {
        "n": n, "queries": total_q, "eps_grid": list(EPS_GRID),
        "buffer_kb": BUFFER_KB, "smoke": smoke, "segments": segs,
        "torch_device": str(system.torch_device), "arms": arms,
        "static_over_adaptive_io": ratio,
        "gates": {
            "adaptive_1p2x_vs_static": ratio >= 1.2,
            "fewer_rebuilds_than_every_drift":
                arms["adaptive"]["rebuilds"]
                < arms["every_drift"]["rebuilds"],
        },
    }
    emit("serving_drift/ratio", 0.0,
         f"static/adaptive={ratio:.2f}x rebuilds="
         f"{arms['adaptive']['rebuilds']}<{arms['every_drift']['rebuilds']}")
    return record


def check_gates(record: dict) -> None:
    arms = record["arms"]
    if not record["gates"]["adaptive_1p2x_vs_static"]:
        raise RuntimeError(f"adaptive only "
                           f"{record['static_over_adaptive_io']:.2f}x better "
                           "than static (< 1.2x)")
    if not record["gates"]["fewer_rebuilds_than_every_drift"]:
        raise RuntimeError(f"adaptive issued {arms['adaptive']['rebuilds']} "
                           f"rebuilds, every_drift "
                           f"{arms['every_drift']['rebuilds']}")


def run(smoke: bool = False, seed: int = 0,
        torch_device: str = DEFAULT_TORCH_DEVICE) -> dict:
    """Measure all arms and hold the two gates; returns the record."""
    record = measure(smoke, seed, torch_device)
    check_gates(record)
    return record


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="CI-sized inputs (~seconds)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=DEFAULT_TORCH_DEVICE)
    args = ap.parse_args(argv)
    record = run(smoke=args.smoke, seed=args.seed, torch_device=args.device)
    print(json.dumps(record, default=float))


if __name__ == "__main__":
    main()
