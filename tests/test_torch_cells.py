"""The port's sharding specs and launch layer against the JAX package (CPU).

* ``tree_specs`` equals ``tuple(jax_spec)`` for every arch's
  ``param_defs`` (and the input and cache roles) under every cell's
  baseline and optimized recipe and under ``Recipe()``, on the meshes
  (16, 16), (2, 16, 16), (32, 8), (2, 32, 8), (2, 2) and (1, 1): JAX
  ``AbstractMesh``es beside ``DeviceMesh``es of a fake 512-rank world.
* ``default_recipe``, ``optimized_overrides``, ``cell_skip_reason`` and
  ``cell_cost`` equal JAX's for every ARCHS x SHAPES x {single, multi-pod}
  x {baseline, optimized} on the v5e mesh shapes, and
  ``roofline_cell(hw=V5E)`` equals JAX's record.
* On the H100 production mesh the recipe takes its data-parallel degree
  from the mesh; ``make_production_mesh`` refuses a world of another
  size.
"""
import dataclasses
import math

import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import ARCHS, SHAPES
from repro.distributed.sharding import Recipe, ShardingCtx
from repro.distributed.sharding import tree_specs as jtree_specs
from repro.launch import analytic as janalytic
from repro.launch import cells as jcells
from repro.launch import roofline as jroofline
from repro.models import model as jmodel
from repro.models import params as jparams
from repro_torch.configs import ARCHS as TARCHS
from repro_torch.configs import SHAPES as TSHAPES
from repro_torch.distributed import sharding as tsh
from repro_torch.launch import analytic, cells, roofline
from repro_torch.launch import mesh as tmesh
from repro_torch.models import model as tmodel
from repro_torch.models import params as tparams

MESHES = [((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")),
          ((32, 8), ("data", "model")),
          ((2, 32, 8), ("pod", "data", "model")),
          ((2, 2), ("data", "model")),
          ((1, 1), ("data", "model"))]
V5E_SHAPES = {False: {"data": 16, "model": 16},
              True: {"pod": 2, "data": 16, "model": 16}}


@pytest.fixture(scope="module")
def fake_world():
    """A fake 512-rank default process group (no collectives run)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=512)
    yield
    dist.destroy_process_group()


def _tmesh(shape, names):
    from torch.distributed.device_mesh import DeviceMesh
    return DeviceMesh("cpu", torch.arange(math.prod(shape)).reshape(shape),
                      mesh_dim_names=names, _init_backend=False)


def _trecipe(recipe: Recipe) -> tsh.Recipe:
    return tsh.Recipe(**dataclasses.asdict(recipe))


def _recipes(arch, multi_pod):
    """JAX's recipes of every cell of ``arch`` (baseline and optimized)
    plus ``Recipe()``."""
    cfg = ARCHS[arch]
    out = [Recipe()]
    for shape in SHAPES.values():
        out.append(jcells.default_recipe(cfg, shape, multi_pod))
        out.append(jcells.default_recipe(
            cfg, shape, multi_pod, **jcells.optimized_overrides(cfg, shape)))
    return out


def _flat_specs(specs, prefix=()):
    if isinstance(specs, dict):
        for k, v in specs.items():
            yield from _flat_specs(v, prefix + (k,))
    else:
        yield prefix, specs


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_tree_specs_equal_jax(arch, fake_world):
    cfg, tcfg = ARCHS[arch], TARCHS[arch]
    defs, tdefs = jparams.param_defs(cfg), tparams.param_defs(tcfg)
    n = 0
    for shape, names in MESHES:
        jmesh, tm = AbstractMesh(shape, names), _tmesh(shape, names)
        for recipe in _recipes(arch, "pod" in names):
            jctx, tctx = ShardingCtx(jmesh, recipe), tsh.ShardingCtx(
                tm, _trecipe(recipe))
            want = dict(_flat_specs(jtree_specs(jctx, defs)))
            got = dict(_flat_specs(tsh.tree_specs(tctx, tdefs)))
            assert set(got) == set(want)
            for path, spec in want.items():
                assert got[path] == tuple(spec), (shape, recipe, path)
                n += 1
            # inputs and caches of every shape carry the same roles
            for sh in SHAPES.values():
                metas = tmodel.input_specs(tcfg, TSHAPES[sh.name])
                dims = jmodel.input_dims(cfg, sh)
                assert tmodel.input_dims(tcfg, TSHAPES[sh.name]) == dims
                for k, m in metas.items():
                    assert tctx.spec(m.shape, dims[k]) == tuple(
                        jctx.spec(m.shape, dims[k]))
            assert tmodel.cache_dims(tcfg) == jmodel.cache_dims(cfg)
    assert n > 0


def test_placements_follow_the_spec(fake_world):
    from torch.distributed.tensor import Replicate, Shard
    ctx = tsh.ShardingCtx(_tmesh((2, 32, 8), ("pod", "data", "model")),
                          tsh.Recipe(batch_axes=("pod", "data")))
    sh = ctx.sharding((256, 4096), ("batch", "heads"))
    assert sh.spec == (("pod", "data"), "model")
    assert sh.placements == (Shard(0), Shard(0), Shard(1))
    assert ctx.sharding((3, 5), ("batch", "heads")).placements == \
        (Replicate(),) * 3
    with pytest.raises(ValueError, match="mesh's axis order"):
        ctx.placements((("data", "pod"),))
    x = torch.ones(2)
    assert tsh.ShardingCtx().constrain(x, "batch") is x
    assert tsh.ShardingCtx().sharding((2,), ("batch",)) is None


def test_axis_group_size(fake_world):
    m = _tmesh((2, 32, 8), ("pod", "data", "model"))
    assert tsh.axis_group_size(m, ("pod", "data")) == 64
    assert tsh.axis_group_size(m, ()) == 1
    assert tsh.axis_sizes(m) == {"pod": 2, "data": 32, "model": 8}


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_cells_and_costs_equal_jax(arch):
    cfg, tcfg = ARCHS[arch], TARCHS[arch]
    for name, shape in SHAPES.items():
        tshape = TSHAPES[name]
        assert cells.cell_skip_reason(tcfg, tshape) == \
            jcells.cell_skip_reason(cfg, shape)
        ov = jcells.optimized_overrides(cfg, shape)
        assert cells.optimized_overrides(tcfg, tshape) == ov
        for mp in (False, True):
            for kw in ({}, ov):
                want = jcells.default_recipe(cfg, shape, mp, **kw)
                got = cells.default_recipe(tcfg, tshape, mp,
                                           mesh_shape=V5E_SHAPES[mp], **kw)
                assert dataclasses.asdict(got) == dataclasses.asdict(want)
                jc = janalytic.cell_cost(cfg, shape, want, V5E_SHAPES[mp])
                tc = analytic.cell_cost(tcfg, tshape, got, V5E_SHAPES[mp])
                assert dataclasses.asdict(tc) == dataclasses.asdict(jc)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_roofline_v5e_equals_jax(arch):
    for shape in SHAPES:
        for mp in (False, True):
            for opt in (False, True):
                want = jroofline.roofline_cell(arch, shape, mp, optimized=opt)
                got = roofline.roofline_cell(arch, shape, mp, optimized=opt,
                                             hw=tmesh.V5E)
                assert got == want, (arch, shape, mp, opt)


def test_h100_mesh_and_recipe():
    cfg, shape = TARCHS["starcoder2-3b"], TSHAPES["train_4k"]
    assert tmesh.production_shape() == ((32, 8), ("data", "model"))
    assert tmesh.production_shape(True) == ((2, 32, 8),
                                            ("pod", "data", "model"))
    # dp 32 (H100 mesh) against JAX's hard-coded v5e 16: 8 rows a rank
    assert cells.default_recipe(cfg, shape).microbatch == 2
    assert cells.default_recipe(
        cfg, shape, mesh_shape={"data": 16, "model": 16}).microbatch == 4
    assert cells.default_recipe(cfg, shape, True).microbatch == 1
    assert tmesh.H100.peak_flops == 989e12 and tmesh.H100.dcn_bw == 50e9
    rows = roofline.roofline_table(hw=tmesh.H100)
    assert len(rows) == len(ARCHS) * len(SHAPES)
    assert {r["mesh"] for r in rows} == {"32x8"}
    ok = [r for r in rows if r["status"] == "ok"]
    assert all(r["step_time_lower_bound_s"] > 0 for r in ok)


def test_make_production_mesh_refuses_a_wrong_world(fake_world):
    with pytest.raises(ValueError, match="needs 256 ranks"):
        tmesh.make_production_mesh(device_type="cpu")
    m = tmesh.make_production_mesh(shape=(2, 16, 16), multi_pod=True,
                                   device_type="cpu")
    assert m.mesh_dim_names == ("pod", "data", "model")
    with pytest.raises(ValueError, match="does not name"):
        tmesh.make_production_mesh(shape=(512,), device_type="cpu")
