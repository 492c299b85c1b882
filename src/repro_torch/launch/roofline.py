"""Roofline analysis driver.

Mirrors ``repro/launch/roofline.py``.  Per (arch x shape) on the
production mesh of the hardware ``hw`` (``H100``: the 32 x 8 cluster mesh;
``V5E``: the JAX package's 16 x 16 pod, which reproduces its table):

  compute_s    = FLOPs_per_device / hw.peak_flops
  memory_s     = HBM_bytes_per_device / hw.hbm_bw
  collective_s = ICI_bytes_per_device / hw.ici_bw (+ DCN term if pods > 1)

The FLOPs and bytes come from ``launch.analytic`` (the JAX package's
closed-form accounting, copied).  On the H100 mesh every non-pod
collective is priced at NVLink's ``ici_bw``, though the "data" axis
crosses InfiniBand between nodes: the collective term is a lower bound
there.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.roofline --all --out results/roofline.json
"""
from __future__ import annotations

import argparse
import json
import math
import os
from typing import Dict, Optional, Union

from repro_torch.configs import ARCHS, SHAPES
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch import analytic
from repro_torch.launch.cells import (cell_skip_reason, default_recipe,
                                      optimized_overrides)
from repro_torch.launch.mesh import H100, V5E, HardwareSpec, production_shape

__all__ = ["roofline_cell", "roofline_table", "mesh_of"]


def mesh_of(hw: HardwareSpec, multi_pod: bool = False) -> Dict[str, int]:
    """{axis: size} of ``hw``'s production mesh."""
    if hw is V5E:
        return ({"pod": 2, "data": 16, "model": 16} if multi_pod
                else {"data": 16, "model": 16})
    dims, names = production_shape(multi_pod)
    return dict(zip(names, dims))


def roofline_cell(arch: str, shape_name: Union[str, ShapeSpec],
                  multi_pod: bool = False,
                  recipe_overrides: Optional[dict] = None,
                  optimized: bool = False, hw: HardwareSpec = H100,
                  mesh_shape: Optional[Dict[str, int]] = None) -> Dict:
    """One cell's record (``shape_name`` may be a ``ShapeSpec`` of its
    own, ``mesh_shape`` a mesh other than ``hw``'s production one)."""
    cfg = ARCHS[arch]
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    if optimized:
        recipe_overrides = {**optimized_overrides(cfg, shape),
                            **(recipe_overrides or {})}
    mesh_shape = mesh_shape or mesh_of(hw, multi_pod)
    rec = {"arch": arch, "shape": shape.name,
           "mesh": "x".join(str(v) for v in mesh_shape.values())}
    skip = cell_skip_reason(cfg, shape)
    if skip:
        rec.update(status="skipped", reason=skip)
        return rec
    n_dev = int(math.prod(mesh_shape.values()))
    recipe = default_recipe(cfg, shape, multi_pod, mesh_shape=mesh_shape,
                            **(recipe_overrides or {}))
    cost = analytic.cell_cost(cfg, shape, recipe, mesh_shape)
    terms = cost.terms(hw, n_dev)
    dominant = max(terms, key=terms.get)
    step_time = max(terms.values())     # perfect-overlap lower bound
    hlo_flops_global = cost.flops * n_dev
    rec.update(
        status="ok",
        recipe={"microbatch": recipe.microbatch, "remat": recipe.remat},
        flops_per_device=cost.flops,
        hbm_bytes_per_device=cost.hbm_bytes,
        ici_bytes_per_device=cost.collective_bytes,
        dcn_bytes_per_device=cost.dcn_bytes,
        terms_s={k: float(v) for k, v in terms.items()},
        dominant=dominant,
        model_flops=cost.model_flops,
        useful_flops_ratio=float(cost.model_flops / max(hlo_flops_global, 1.0)),
        # roofline fraction: useful model FLOP/s achieved at the bound
        # implied by the dominant term, vs chip peak.
        roofline_fraction=float(
            cost.model_flops / max(step_time, 1e-12) / (n_dev * hw.peak_flops)),
        step_time_lower_bound_s=float(step_time),
        breakdown={k: float(v) for k, v in cost.breakdown.items()},
    )
    return rec


def roofline_table(multi_pod: bool = False, optimized: bool = False,
                   hw: HardwareSpec = H100):
    rows = []
    for arch in ARCHS:
        for shape in SHAPES:
            rows.append(roofline_cell(arch, shape, multi_pod,
                                      optimized=optimized, hw=hw))
    return rows


def _fmt_row(r: Dict) -> str:
    if r["status"] != "ok":
        return (f"| {r['arch']} | {r['shape']} | — | — | — | — | skipped | — |")
    t = r["terms_s"]
    return ("| {arch} | {shape} | {c:.2e} | {m:.2e} | {x:.2e} | {dom} | "
            "{ratio:.2f} | {rf:.1%} |".format(
                arch=r["arch"], shape=r["shape"], c=t["compute_s"],
                m=t["memory_s"], x=t["collective_s"], dom=r["dominant"],
                ratio=r["useful_flops_ratio"], rf=r["roofline_fraction"]))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--optimized", action="store_true")
    ap.add_argument("--hw", choices=("h100", "v5e"), default="h100")
    ap.add_argument("--out", default="results/roofline.json")
    args = ap.parse_args(argv)
    hw = H100 if args.hw == "h100" else V5E
    if args.all:
        rows = roofline_table(args.multi_pod, args.optimized, hw)
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape (or --all)")
        rows = [roofline_cell(args.arch, args.shape, args.multi_pod,
                              optimized=args.optimized, hw=hw)]
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rows, f, indent=1)
    print("| arch | shape | compute_s | memory_s | collective_s | dominant "
          "| useful/HLO | roofline frac |")
    print("|---|---|---|---|---|---|---|---|")
    for r in rows:
        print(_fmt_row(r))


if __name__ == "__main__":
    main()
