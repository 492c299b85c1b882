"""Benchmark driver — one twin per paper table/figure.

The port's twin of the JAX package's ``benchmarks/run.py``: the same table
of names, ``--only`` and ``--smoke``, every benchmark run through
``repro_torch`` on ``--device``.  Prints ``name,us_per_call,derived`` CSV.
A benchmark that raises prints the reference's ``ERROR:`` line and the
driver goes on, as the reference does; it then exits 1 if any benchmark
failed, so a failure cannot pass as success.

    PYTHONPATH=src python -m repro_torch.launch.bench_run --smoke

Runs on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import sys
import time

from repro_torch.core.session import DEFAULT_TORCH_DEVICE
from repro_torch.launch.bench_common import smoke_kwargs


def table() -> dict:
    from repro_torch.launch import (bench_covariance, bench_engine,
                                    bench_estimate_grid, bench_fetch_strategy,
                                    bench_io_size, bench_join,
                                    bench_kernels, bench_kv_planner,
                                    bench_pgm_tuning_curve,
                                    bench_point_accuracy, bench_profile_grid,
                                    bench_range_accuracy,
                                    bench_rmi_tuning_curve,
                                    bench_serving_drift, bench_sharding,
                                    bench_tuning_e2e, bench_write_path)

    return {
        "point_accuracy": bench_point_accuracy.run,     # Table IV / Fig 1
        "range_accuracy": bench_range_accuracy.run,     # Table V
        "io_size": bench_io_size.run,                   # Table I
        "covariance": bench_covariance.run,             # Table II
        "fetch_strategy": bench_fetch_strategy.run,     # Fig 5 + Lemmas
        "pgm_tuning_curve": bench_pgm_tuning_curve.run,  # Fig 7
        "rmi_tuning_curve": bench_rmi_tuning_curve.run,  # Fig 8
        "tuning_e2e": bench_tuning_e2e.run,             # Figs 9/10
        "join": bench_join.run,                         # Fig 11
        "kernels": bench_kernels.run,                   # che_solver kernel
        "kv_planner": bench_kv_planner.run,             # Eq. 15 on KV pools
        "estimate_grid": bench_estimate_grid.run,       # grid vs loop
        "serving_drift": bench_serving_drift.run,       # adaptive vs static
        "write_path": bench_write_path.run,             # CAM merge scheduler
        "sharding": bench_sharding.run,                 # solved vs even split
        "engine": bench_engine.run,                     # fused vs host
        "profile_grid": bench_profile_grid.run,         # occupancy kernel
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", nargs="*", default=None,
                    help="subset of benchmark names")
    ap.add_argument("--smoke", action="store_true",
                    help="CI-sized inputs (~10x below the CPU default)")
    ap.add_argument("--device", default=DEFAULT_TORCH_DEVICE)
    args = ap.parse_args(argv)

    benches = table()
    names = args.only or list(benches)
    unknown = [n for n in names if n not in benches]
    if unknown:
        ap.error(f"unknown benchmarks {unknown}; expected some of "
                 f"{sorted(benches)}")
    print("name,us_per_call,derived")
    failed = []
    for name in names:
        fn = benches[name]
        kwargs = smoke_kwargs(fn) if args.smoke else {}
        t0 = time.perf_counter()
        try:
            fn(**kwargs, torch_device=args.device)
        except Exception as e:  # noqa: BLE001 — keep the suite running
            print(f"{name},0,ERROR:{type(e).__name__}:{e}", flush=True)
            failed.append(name)
        print(f"# {name} done in {time.perf_counter() - t0:.1f}s",
              file=sys.stderr, flush=True)
    if failed:
        print(f"# failed: {' '.join(failed)}", file=sys.stderr, flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
