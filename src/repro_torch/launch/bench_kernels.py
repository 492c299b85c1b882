"""Kernel-level benchmark: the multi-candidate Che solver vs scalar
bisection — pass accounting plus wall-clock sanity.

The port's twin of the JAX package's ``benchmarks/bench_kernels.py``: the
same Zipf page probabilities and capacity, with the scalar bisection
(``cache_models.solve_che_time``) and the K-way solver
(``kernels.ops.che_solve``, k 8, 16 passes) on tensors on the torch
device.  On the card the solver is one ``che_solve`` CUDA launch a call;
on CPU tensors it runs its plain version (``che_solve_ref``).  Each timed
call ends in a host value.  ``hbm_passes`` are the reference's pass
counts (64 bisection passes against 16), not times.  The record is
printed as the last line of standard output (JSON).

    PYTHONPATH=src python -m repro_torch.launch.bench_kernels --smoke

Runs on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.cache_models import solve_che_time
from repro_torch.core.session import (DEFAULT_TORCH_DEVICE,
                                      resolve_torch_device)
from repro_torch.kernels import ops
from repro_torch.launch.bench_common import Timer, emit, main_for


def run(n_pages=200_000, torch_device=DEFAULT_TORCH_DEVICE):
    dev = resolve_torch_device(torch_device)
    rng = np.random.default_rng(0)
    p = rng.zipf(1.3, n_pages).astype(np.float64)
    p = torch.as_tensor(p / p.sum(), dtype=torch.float32, device=dev)
    cap = n_pages * 0.1

    # warm
    t_scalar = float(solve_che_time(p, cap))
    with Timer() as t1:
        t_scalar = float(solve_che_time(p, cap))
    t_multi = float(ops.che_solve(p, cap, k=8, iters=16))
    with Timer() as t2:
        t_multi = float(ops.che_solve(p, cap, k=8, iters=16))

    passes_scalar = 64          # fixed-iteration bisection
    passes_multi = 16           # K=8 log-subdivision to equal precision
    consistency = float(torch.sum(-torch.expm1(-p * t_multi)))
    consistency_err = abs(consistency - cap) / cap
    emit("kernels/che_solver", t2.seconds * 1e6,
         f"hbm_passes={passes_multi}_vs_{passes_scalar}"
         f"(traffic_reduction={passes_scalar / passes_multi:.1f}x)"
         f";scalar_s={t1.seconds:.4f};multi_s={t2.seconds:.4f}"
         f";consistency_err={consistency_err:.2e}")
    return {"n_pages": int(n_pages), "capacity": cap,
            "torch_device": str(torch_device),
            "hbm_passes": passes_multi, "hbm_passes_scalar": passes_scalar,
            "traffic_reduction": passes_scalar / passes_multi,
            "t_scalar": t_scalar, "t_multi": t_multi,
            "scalar_seconds": t1.seconds, "multi_seconds": t2.seconds,
            "consistency_err": consistency_err}


def main(argv=None):
    return main_for(run, __doc__, argv)


if __name__ == "__main__":
    main()
