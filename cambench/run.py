"""Run one cell of ``BENCHMARK.json`` and print its result line.

    python3 -m cambench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout of the repository, on a machine with as many
NVIDIA GPUs as the cell asks for; without them it exits 2 and prints no
result.  Set-up makes every input from ``--seed``, warms the cell's shapes
and counts that as ``setup_s``; the window then runs for ``--seconds``; the
correctness check runs once the window has closed and the program's state
is freed.  The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` and, with ``--trace 1``,
``breakdown``, then ``checks``: each compared number beside its limit, also
printed as the last lines of standard error).

``--rehearse`` runs the cell on the CPU at a hundredth of its keys and
queries with the kernels' plain versions: a test of the harness, never a
measurement.
"""
from __future__ import annotations

import argparse
import importlib
import json
import os
import sys

from cambench.harness import ROOT, forbidden_modules, load_json, read_metric


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rehearse", action="store_true",
                    help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def fixed_caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    cache = ROOT / "build"
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(cache / "repro_torch")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "nv")


class Context:
    """One run: the cell and the files it names, and where it runs."""

    def __init__(self, args, bench):
        cells = {w["name"]: w for w in bench["workloads"]}
        if args.workload not in cells:
            raise SystemExit(f"unknown workload {args.workload!r}; "
                             f"BENCHMARK.json has {sorted(cells)}")
        self.args = args
        self.cell = cells[args.workload]
        configs = {c["name"]: c for c in bench["configs"]}
        self.config = load_json(ROOT / configs[self.cell["config"]]["file"])
        self.traffic = load_json(ROOT / "cambench" / "traffic"
                                 / f"{self.cell['traffic']}.json")
        self.limits = load_json(ROOT / "cambench" / "limits"
                                / f"{args.workload}.json")["limits"]
        self.rehearse = bool(args.rehearse)
        self.device = "cpu" if self.rehearse else "cuda"
        self.shrink = 100 if self.rehearse else 1
        self.seed = args.seed & ((1 << 64) - 1)

    def rng(self, *stream):
        import numpy as np
        return np.random.default_rng([self.seed, *stream])


def cell_metrics(bench, name: str, trace: bool):
    """The cell's end-to-end metrics, or with ``trace`` its per-layer ones."""
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if name in m.get("workloads", [name]) and m["moves"] in moved]


def device_info(torch, ctx, peak: int):
    if ctx.device == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": int(ctx.cell["chips"]), "memory_peak_bytes": peak}
    return {"platform": "cpu", "kind": "rehearsal", "count": 1,
            "memory_peak_bytes": peak}


def main(argv=None) -> int:
    args = parse_args(sys.argv[1:] if argv is None else argv)
    fixed_caches()
    sys.path.insert(0, str(ROOT / "src"))
    bench = load_json(ROOT / "BENCHMARK.json")
    ctx = Context(args, bench)
    import torch

    if not ctx.rehearse and (not torch.cuda.is_available()
                             or torch.cuda.device_count()
                             < int(ctx.cell["chips"])):
        print(f"{args.workload} needs {ctx.cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    driver = importlib.import_module(f"cambench.drivers.{ctx.traffic['driver']}")
    out = driver.run(ctx)
    metrics = {}
    for m in cell_metrics(bench, args.workload, bool(args.trace)):
        if args.trace:
            value = read_metric(m["name"], out["readings"])
        else:
            value = out["e2e"].get(m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = device_info(torch, ctx, out["memory_peak_bytes"])
    line = {"correct": out["correct"], "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics, "device": dev}
    if args.trace and out["readings"] is not None:
        trace = out["readings"].trace
        dev["busy_s"], dev["window_s"] = trace.busy_s, trace.window_s
        line["breakdown"] = trace.breakdown()
    line["checks"] = {k: {"value": v, "limit": lim}
                      for k, (v, lim) in out["checks"].items()}
    found = forbidden_modules()
    if found:
        print(f"modules loaded that the benchmark may not load: {found}",
              file=sys.stderr)
        return 3
    for err in out["errors"][:5]:
        print(f"failed request: {err}", file=sys.stderr)
    for k, (v, lim) in out["checks"].items():
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
