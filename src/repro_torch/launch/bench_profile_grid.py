"""Device profiling benchmark: the mixed-eps occupancy kernel vs the host
LUT-gather + bincount reference.

The port's twin of the JAX package's ``benchmarks/bench_profile_grid.py``:
the same synthetic mixed-eps profiling batch (K candidate rows x Q point
queries, pow2 leaf-eps classes drawn per reference — the §V-C RMI shape),
run through both mixed-eps kernels:

* ``host``   — ``core.page_ref.point_page_refs_mixed_eps_grid`` (gathered
  float64 LUT rows + ``np.bincount`` per class), numpy on the host CPU
  whatever the torch device (``host_device`` in the record);
* ``device`` — ``kernels.profile_grid.point_page_refs_mixed_eps_grid``:
  the ``profile_grid`` CUDA kernel on the card (its plain torch version on
  CPU tensors), histogram rows born on the device for the chained
  profile→price path.

Gates: <= 2e-6 normalized occupancy equivalence and matching totals,
asserted on both devices.  On the card both are timed warm (the device
call ends in a copy of its histograms to the host) and the reference's
>= 2x verdict is recorded under its key (``fused_2.0x_warm``), not
asserted; on the CPU it is ``None``.  The record is printed as the last
line of standard output (JSON).

    PYTHONPATH=src python -m repro_torch.launch.bench_profile_grid --smoke

Runs on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import json

import numpy as np
import torch

from repro_torch.core import page_ref
from repro_torch.core.session import (DEFAULT_TORCH_DEVICE,
                                      resolve_torch_device)
from repro_torch.kernels import profile_grid
from repro_torch.launch.bench_common import GEOM, best_seconds, emit

K_ROWS = 8                   # candidate rows profiled per launch
EPS_CLASSES = (4, 16, 64, 256, 1024)   # pow2 leaf-eps mixture
REPEATS = 3
GATE_SPEEDUP = 2.0


def _batch(num_pages: int, nq: int, seed: int):
    rng = np.random.default_rng(seed)
    # zipf-ish hot set over the key space, like a w4 point workload
    pos = rng.zipf(1.2, nq) % (num_pages * GEOM.c_ipp)
    eps_rows = rng.choice(EPS_CLASSES, size=(K_ROWS, nq)).astype(np.int64)
    return pos.astype(np.int64), eps_rows


def run(smoke: bool = False, seed: int = 0,
        torch_device: str = DEFAULT_TORCH_DEVICE) -> dict:
    dev = resolve_torch_device(torch_device)
    num_pages, nq = (512, 20_000) if smoke else (4096, 200_000)
    positions, eps_rows = _batch(num_pages, nq, seed)

    counts_h, totals_h = page_ref.point_page_refs_mixed_eps_grid(
        positions, eps_rows, GEOM.c_ipp, num_pages)
    counts_d, totals_d = profile_grid.point_page_refs_mixed_eps_grid(
        positions, eps_rows, GEOM.c_ipp, num_pages, device=dev)
    ch = np.asarray(counts_h, np.float64)
    cd = counts_d.to("cpu", torch.float64).numpy()
    scale = max(1.0, float(ch.max()))
    dh = float(np.max(np.abs(ch - cd))) / scale
    dt = float(np.max(np.abs(np.asarray(totals_h) - np.asarray(totals_d))
                      / np.maximum(np.asarray(totals_h), 1.0)))
    equivalent = dh < 2e-6 and dt < 2e-6

    host_s = best_seconds(lambda: page_ref.point_page_refs_mixed_eps_grid(
        positions, eps_rows, GEOM.c_ipp, num_pages), REPEATS)
    device_s = best_seconds(
        lambda: profile_grid.point_page_refs_mixed_eps_grid(
            positions, eps_rows, GEOM.c_ipp, num_pages, device=dev)[0].cpu(),
        REPEATS)
    speedup = host_s / device_s
    on_card = dev.type == "cuda"

    record = {
        "rows": K_ROWS, "queries": nq, "num_pages": num_pages,
        "c_ipp": GEOM.c_ipp, "eps_classes": list(EPS_CLASSES),
        "backend": dev.type, "torch_device": str(torch_device),
        "host_device": "cpu (numpy)",
        "fused_timed": on_card,         # the CPU runs the plain version
        "host_seconds_warm": host_s, "device_seconds_warm": device_s,
        "device_over_host_speedup": speedup,
        "max_norm_occupancy_diff": dh, "max_rel_totals_diff": dt,
        "smoke": smoke,
        "gates": {
            "float32_equivalent": bool(equivalent),
            f"fused_{GATE_SPEEDUP}x_warm": (bool(speedup >= GATE_SPEEDUP)
                                            if on_card else None),
        },
    }
    emit("profile/host", 1e6 * host_s, f"{K_ROWS}x{nq} refs warm")
    emit("profile/device", 1e6 * device_s,
         f"speedup={speedup:.2f}x dh={dh:.1e} "
         f"({'timed' if on_card else 'cpu: structure-only'})")

    if not equivalent:
        raise RuntimeError(
            f"occupancy kernels diverge: norm dh = {dh}, totals dt = {dt}")
    return record


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="CI-sized inputs")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=DEFAULT_TORCH_DEVICE)
    args = ap.parse_args(argv)
    print("name,us_per_call,derived")
    record = run(smoke=args.smoke, seed=args.seed, torch_device=args.device)
    print(json.dumps(record, default=float))
    return record


if __name__ == "__main__":
    main()
