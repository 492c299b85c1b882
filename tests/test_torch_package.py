"""Packaging guarantees of the port.

* Importing every ``repro_torch`` module — the CAM path, the serving path
  and the training path alike — (and reading ``chip_smoke.py``'s
  imports) pulls in neither
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
                 "launch.bench_write_path", "train.optimizer",
                 "train.train_step", "data.pipeline",
                 "distributed.checkpoint", "distributed.fault_tolerance",
                 "launch.train", "launch.train_lm",
                 "distributed.compression", "distributed.elastic",
                 "launch.mesh", "launch.cells", "launch.analytic",
                 "launch.roofline", "launch.dryrun", "launch.collectives",
                 "tuning.pgm_tuner", "tuning.rmi_tuner", "tuning.rs_tuner",
                 "launch.bench_common", "launch.bench_tuning_e2e",
                 "launch.quickstart", "launch.tune_pgm",
                 "launch.bench_engine", "launch.bench_profile_grid",
                 "launch.bench_estimate_grid",
                 "launch.bench_pgm_tuning_curve",
                 "launch.bench_rmi_tuning_curve",
                 "launch.bench_point_accuracy",
                 "launch.bench_range_accuracy", "launch.bench_io_size",
                 "launch.bench_covariance", "launch.bench_fetch_strategy",
                 "launch.bench_kernels", "launch.bench_run",
                 "launch.bench_join", "launch.hybrid_join",
                 "launch.join_tree", "launch.serve_adaptive",
                 "launch.shard_fleet", "launch.update_heavy",
                 "launch.bench_kv_planner"):
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


def test_train_entry_points_default_to_the_card(monkeypatch, tmp_path):
    import inspect

    from repro_torch.launch import train, train_lm

    assert inspect.signature(train.build_trainer).parameters[
        "device"].default == "cuda"
    assert inspect.signature(train_lm.run).parameters[
        "torch_device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--reduced", "--steps", "1", "--ckpt-dir",
                    str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_lm.main(["--smoke"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.build_trainer(None, None, None)
    assert not list(tmp_path.iterdir())
    res = train.main(["--reduced", "--steps", "2", "--batch", "2", "--seq",
                      "16", "--ckpt-dir", str(tmp_path), "--device", "cpu"])
    assert res["final_step"] == 2 and len(res["losses"]) == 2


#: The twins of the paper's scripts (each ``run`` takes ``torch_device``).
PAPER_TWINS = ("bench_tuning_e2e", "quickstart", "tune_pgm", "bench_engine",
               "bench_profile_grid", "bench_estimate_grid",
               "bench_pgm_tuning_curve", "bench_rmi_tuning_curve",
               "bench_point_accuracy", "bench_range_accuracy",
               "bench_io_size", "bench_covariance", "bench_fetch_strategy",
               "bench_kernels")


def test_paper_twins_and_shims_default_to_the_card(monkeypatch):
    import importlib
    import inspect

    import numpy as np

    from repro_torch.core.cam import CamGeometry
    from repro_torch.index.rmi import build_rmi
    from repro_torch.launch import bench_common, bench_run
    from repro_torch.tuning import pgm_tuner, rmi_tuner, rs_tuner

    keys = np.sort(np.random.default_rng(0).uniform(0, 1e6, 4096))
    pos = np.arange(0, 4096, 7)
    geom = CamGeometry()
    shims = {
        pgm_tuner.cam_tune_pgm: lambda: pgm_tuner.cam_tune_pgm(
            keys, pos, 1 << 20, geom),
        pgm_tuner.multicriteria_pgm_tune:
            lambda: pgm_tuner.multicriteria_pgm_tune(keys, 1 << 20),
        rmi_tuner.estimate_rmi_io: lambda: rmi_tuner.estimate_rmi_io(
            build_rmi(keys, 64), pos, keys[pos], geom, 1 << 20),
        rmi_tuner.cam_tune_rmi: lambda: rmi_tuner.cam_tune_rmi(
            keys, pos, keys[pos], 1 << 20, geom),
        rmi_tuner.cdfshop_tune_rmi:
            lambda: rmi_tuner.cdfshop_tune_rmi(keys, 1 << 20),
        rs_tuner.cam_tune_radixspline: lambda: rs_tuner.cam_tune_radixspline(
            keys, pos, 1 << 20, geom),
    }
    twins = [importlib.import_module(f"repro_torch.launch.{name}")
             for name in PAPER_TWINS]
    for fn in [*shims, *(m.run for m in twins)]:
        assert inspect.signature(fn).parameters[
            "torch_device"].default == "cuda", fn.__qualname__
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn, call in shims.items():
        with pytest.warns(DeprecationWarning), \
                pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    for mod in twins:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            mod.run(**bench_common.smoke_kwargs(mod.run))
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            mod.main(["--smoke"])
    # the driver reports each refusal and exits 1
    assert bench_run.main(["--smoke", "--only", "io_size", "kernels"]) == 1


#: The twins of the join and online scripts, each with the first piece of
#: work its ``run`` does after resolving the device.
LATER_TWINS = {"bench_join": "dataset", "hybrid_join": "make_dataset",
               "join_tree": "make_dataset", "serve_adaptive": "make_dataset",
               "shard_fleet": "make_dataset",
               "update_heavy": "synthetic_drifting_trace",
               "bench_kv_planner": "block_popularity"}


@pytest.mark.parametrize("name", sorted(LATER_TWINS))
def test_join_and_online_twins_default_to_the_card_and_refuse_first(
        monkeypatch, name):
    import importlib
    import inspect

    from repro_torch.launch import bench_common

    mod = importlib.import_module(f"repro_torch.launch.{name}")
    assert inspect.signature(mod.run).parameters[
        "torch_device"].default == "cuda"

    def work(*a, **kw):
        raise AssertionError(f"{name} worked before refusing the card")

    monkeypatch.setattr(mod, LATER_TWINS[name], work)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.run(**bench_common.smoke_kwargs(mod.run))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main(["--smoke"])
