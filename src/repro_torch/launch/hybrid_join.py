"""CAM-guided hybrid join (paper §VI): density-aware point/range probing.

The port's twin of the JAX package's ``examples/hybrid_join.py``: the same
data, buffer, workloads and printed lines, run through ``repro_torch`` on
a torch device.  ``run`` also returns the numbers it prints.

The join layer speaks the same three nouns as cost estimation — an
``IndexModel`` of the inner relation (``PGMAdapter.build(keys, eps=64)``),
a ``System`` (page geometry, memory budget, policy) and the outer probe
stream — bound in a ``JoinSession``: ``calibrate`` fits the Eq. 17
coefficients, ``choose`` prices all four strategies ("inlj",
"point-only", "range-only", "hybrid" by Algorithm 2's segments) and picks
one, ``execute`` replays a plan exactly.

    PYTHONPATH=src python -m repro_torch.launch.hybrid_join --smoke

Runs on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import json

from repro_torch.core.cam import CamGeometry
from repro_torch.core.session import (DEFAULT_TORCH_DEVICE, System,
                                      resolve_torch_device)
from repro_torch.data.datasets import make_dataset
from repro_torch.data.workloads import WorkloadSpec, join_outer_keys
from repro_torch.index.adapters import PGMAdapter
from repro_torch.join.session import STRATEGIES, JoinSession

WORKLOADS = ("w1", "w3", "w4")


def run(smoke: bool = False,
        torch_device: str = DEFAULT_TORCH_DEVICE) -> dict:
    resolve_torch_device(torch_device)   # refuse a missing card first
    n, n_outer = (200_000, 20_000) if smoke else (1_000_000, 100_000)
    inner_keys = make_dataset("books", n, seed=1)
    inner = PGMAdapter.build(inner_keys, eps=64)
    system = System(CamGeometry(), memory_budget_bytes=(1 << 20)
                    + inner.size_bytes, policy="lru",
                    torch_device=torch_device)

    session = JoinSession(inner, system, inner_keys=inner_keys)
    params = session.calibrate()
    print(f"calibrated cost model: alpha={params.alpha:.2e} "
          f"beta={params.beta:.2e} lambda_point={params.lambda_point:.2e}"
          f" lambda_range={params.lambda_range:.2e}\n")

    workloads = {}
    for wl in WORKLOADS:
        outer = join_outer_keys(inner_keys, n_outer, WorkloadSpec(wl, seed=9))
        print(f"workload {wl} ({n_outer // 1000}k outer x {n // 1000}k "
              f"inner, {session.capacity} buffer pages):")
        chosen = session.choose(outer, n_min=256, k_max=4096)
        rows = {}
        for strategy in STRATEGIES:
            plan = chosen.plans[strategy]
            st = session.execute(plan)
            mark = " <- chosen" if strategy == chosen.strategy else ""
            extra = (f"  [{plan.n_range_segments}/{len(plan.segments)} "
                     f"segments ran as range]" if strategy == "hybrid"
                     else "")
            print(f"  {st.strategy:11s} {st.seconds:7.3f}s "
                  f"(predicted {plan.cost.seconds:7.3f}s)  "
                  f"io={st.physical_ios:7d}  matches={st.matches}"
                  f"{extra}{mark}")
            rows[strategy] = {"seconds": st.seconds,
                              "predicted_seconds": plan.cost.seconds,
                              "physical_ios": int(st.physical_ios),
                              "matches": int(st.matches),
                              "range_segments": int(plan.n_range_segments),
                              "segments": len(plan.segments)}
        print()
        workloads[wl] = {"chosen": chosen.strategy, "strategies": rows}
    return {"n": n, "n_outer": n_outer, "torch_device": str(torch_device),
            "capacity_pages": int(session.capacity),
            "params": {k: getattr(params, k) for k in (
                "alpha", "beta", "lambda_point", "lambda_range")},
            "workloads": workloads}


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="CI-sized inputs (~5x below the demo default)")
    ap.add_argument("--device", default=DEFAULT_TORCH_DEVICE)
    args = ap.parse_args(argv)
    out = run(smoke=args.smoke, torch_device=args.device)
    print(json.dumps(out, default=float))
    return out


if __name__ == "__main__":
    main()
