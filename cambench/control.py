"""The control of a cell's correctness check, and its readings.

    python3 -m cambench.control --workload pgm.tune-w4 --seeds 5 6 7

For each seed it makes the cell's inputs as a run does, puts the
reference in the program's place computed in the precision below the
configuration's float32 (profiles through TF32 matrix products, hit rates
in bfloat16), and prints the numbers the check compares as one JSON line
a seed.  The check is sound only if the control fails it: at least one
number above its limit.  Runs on the card (``--device cpu`` for a test).
"""
from __future__ import annotations

import argparse
import json
import sys

from cambench.harness import ROOT, load_json


def tune_control(ctx):
    import torch

    from cambench.drivers.tune import Inputs, compare
    from cambench.reference.tune import reference_entries

    inp = Inputs(ctx)
    ref = reference_entries(ctx, inp, inp.checked)
    low = reference_entries(ctx, inp, inp.checked,
                            profile_dtype=torch.float32, tf32=True,
                            price_dtype=torch.bfloat16)
    answers, results = {}, []
    for entry in inp.checked:
        cells = low[entry]["cells"]
        est = min(v[1] for v in cells.values())
        answers[entry] = (inp.pool[entry][0], low[entry]["counts"])
        results.append((entry, {"cells": cells, "est_io": est}))
    return compare(ctx, inp, answers, results, 0, reference=ref)


def online_control(ctx, batches: int = 120):
    """The reference's own serving run at the lower precision, judged by
    the float64 reference following it (about a window's batches)."""
    import numpy as np
    import torch

    from cambench.drivers.online import Inputs, check
    from cambench.reference.online import OnlineReference, run_alone
    from cambench.reference.tune import knob_sizes

    inp = Inputs(ctx)
    sizes, _ = knob_sizes(inp)
    low = OnlineReference(inp, sizes, ctx.device,
                          profile_dtype=torch.float32,
                          price_dtype=torch.bfloat16,
                          summary_dtype=np.float32)
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        program = run_alone(low, inp.warm, inp.stream, batches, 2)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    numbers = {"failed": 0.0, "locate_miss": 0.0}
    numbers.update(check(ctx, inp, program))
    return numbers


CONTROLS = {"tune": tune_control, "online": online_control}


def main(argv=None) -> int:
    from cambench.run import Context, fixed_caches

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    a = ap.parse_args(argv)
    fixed_caches()
    bench = load_json(ROOT / "BENCHMARK.json")
    for seed in a.seeds:
        args = argparse.Namespace(workload=a.workload, seed=seed,
                                  seconds=0.0, trace=0,
                                  rehearse=a.device == "cpu")
        ctx = Context(args, bench)
        numbers = CONTROLS[ctx.traffic["driver"]](ctx)
        over = sorted(k for k, v in numbers.items() if v > ctx.limits[k])
        print(json.dumps({"workload": a.workload, "seed": seed,
                          "control": numbers, "over_limit": over}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
