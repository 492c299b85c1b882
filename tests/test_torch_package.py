"""Packaging guarantees of the port.

* Importing every ``repro_torch`` module — the CAM path and the serving
  path alike — (and reading ``chip_smoke.py``'s imports) pulls in neither
  ``jax`` nor the ``repro`` package — checked in a fresh interpreter.
* Entry points default to the card; without one a default-device session
  raises instead of running on the CPU, and a CPU session must be asked
  for.
"""
import ast
import dataclasses
import pathlib
import subprocess
import sys
import textwrap

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(PKG.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_port_imports_without_jax_or_repro():
    mods = list(_modules())
    for name in ("kernels.price_grid", "kernels.che_solver",
                 "kernels.flash_attention", "kernels.decode_attention",
                 "kernels.ops", "kernels.ref", "configs.yi_34b",
                 "distributed.sharding", "models.transformer", "models.model",
                 "serve.engine", "serve.planner", "launch.serve",
                 "join.session", "join.tree", "sim.machine",
                 "configs.cam_paper", "serving.session", "serving.sketch",
                 "write.session", "sharding.session",
                 "launch.bench_serving_drift", "launch.bench_sharding",
                 "launch.bench_write_path"):
        assert "repro_torch." + name in mods
    code = textwrap.dedent(f"""
        import importlib, sys
        for name in {mods!r}:
            importlib.import_module(name)
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "repro"))
        print(bad)
        sys.exit(1 if bad else 0)
    """)
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
           "JAX_PLATFORMS": "cpu"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=str(ROOT), timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def test_chip_smoke_imports_nothing_of_jax():
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    assert not roots & {"jax", "jaxlib", "repro"}, roots
    assert "repro_torch" in roots


def test_default_device_is_the_card_and_never_falls_back(monkeypatch):
    from repro_torch.core.session import CostSession, System
    from repro_torch.tuning.session import TuningSession

    assert System.__dataclass_fields__["torch_device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        System()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CostSession(System(memory_budget_bytes=1 << 20))
    cpu = System(torch_device="cpu")
    assert CostSession(cpu).device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TuningSession(dataclasses.replace(cpu, torch_device="cuda"))
    # budget overrides rebuild the System and keep its torch device
    ts = TuningSession(cpu)
    assert dataclasses.replace(ts.system, memory_budget_bytes=2.0
                               ).torch_device == "cpu"


def test_convert_grid_profiles_roundtrip():
    import numpy as np

    from repro_torch import convert

    counts = np.arange(12, dtype=np.float64).reshape(2, 6)
    prof = convert.grid_profiles(
        knobs=(8, 16), counts=counts, totals=counts.sum(1), dacs=[1.0, 1.1],
        sizes=[10.0, 5.0], caps=[4, 5], scale=2.0, n_queries=3,
        sparts=(None, dict(total_refs=4.0, distinct_pages=2.0,
                           min_capacity=1, coverage=np.ones(6),
                           pinned_retouches=0.0)),
        wparts=(dict(counts=np.ones(6), total_refs=6.0), None),
        skipped=((32, "too big"),), device="cpu")
    assert prof.counts.dtype == torch.float32
    assert prof.counts.device.type == "cpu"
    assert torch.equal(prof.counts, torch.as_tensor(counts).float())
    assert prof.sparts[0] is None and prof.sorted_refs(1) == 4.0
    assert prof.write_refs(0) == 6.0 and prof.wpart(1) is None
    assert prof.skipped[0].knob == 32 and prof.caps.dtype == np.int64


def test_serve_entry_points_default_to_the_card(monkeypatch):
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.planner import RequestMix, plan_kv_pool

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduced(ARCHS["yi-34b"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServeEngine(cfg, {})
    mix = RequestMix(n_requests=4, shared_prefix=64, mean_context=128,
                     decode_steps=4, kv_bytes_per_token=1024)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        plan_kv_pool(mix, hbm_budget_bytes=2**30, weight_bytes=0.0)
    assert ServeEngine(cfg, {}, device="cpu").device.type == "cpu"
