"""The port's sharding rules against the reference's: ``param_specs`` (per
layer, the reference's stacked spec with its leading segment axis
dropped), ``cache_specs`` and ``batch_spec`` for all ten archs at full and
smoke widths on the meshes (16, 16), (2, 16, 16), (2, 4) and (1, 1). The
reference side is evaluated on ``jax.sharding.AbstractMesh`` over
``jax.eval_shape`` trees, the port's on ``launch.mesh.AbstractMesh`` over
meta tensors: no device and no process group. Under a fake process group,
every DTensor made from a spec has the local shape the spec implies."""
from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import get_smoke_config as ref_get_smoke_config
from repro.models import model as RM
from repro.models import sharding as RS
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.launch import mesh as meshmod
from repro_torch.models import model as M
from repro_torch.models import sharding as S
from repro_torch.models import steps as steps_mod

MESHES = {
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "2x4": ((2, 4), ("data", "model")),
    "1x1": ((1, 1), ("data", "model")),
}


def _norm(spec) -> tuple:
    """A spec's entries with a lone axis name and a 1-tuple of it alike."""
    return tuple(None if e is None else (e,) if isinstance(e, str) else tuple(e)
                 for e in spec)


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("width", ["full", "smoke"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_equal_the_reference(arch, width, mesh_name):
    shape, axes = MESHES[mesh_name]
    ref_mesh = jax.sharding.AbstractMesh(shape, axes)
    mesh = meshmod.AbstractMesh(shape, axes)
    rcfg = (ref_get_config if width == "full" else ref_get_smoke_config)(arch)
    cfg = (get_config if width == "full" else get_smoke_config)(arch)

    # parameters: each per-layer tensor against its stacked leaf's spec
    ref_params = jax.eval_shape(lambda k: RM.init_params(k, rcfg), jax.random.PRNGKey(0))
    ref_specs = RS.param_specs(ref_params, rcfg, ref_mesh)
    model = M.param_shapes(cfg)
    specs = S.param_specs(model, cfg, mesh)
    slots = M._reference_slots(model, cfg)
    assert list(specs) == list(slots)
    for name, (path, j) in slots.items():
        want = tuple(_at(ref_specs, path))
        if j is not None:
            assert want[0] is None, (name, want)
            want = want[1:]
        assert _norm(specs[name]) == _norm(want), (name, specs[name], want)

    # caches: the reference's stacked leaves, leaf for leaf
    if cfg.has_decode:
        B, s_max = (128, 32768) if width == "full" else (8, 2048)
        ref_cache = jax.eval_shape(lambda: RM.init_cache(rcfg, B, s_max))
        ref_cs = jax.tree.leaves(RS.cache_specs(ref_cache, rcfg, ref_mesh, B),
                                 is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        cs = S.cache_specs(M.cache_shapes(cfg, B, s_max), cfg, mesh, B)
        got = [spec for seg in cs for spec in M.cache_leaves(seg)]
        assert [_norm(g) for g in got] == [_norm(tuple(r)) for r in ref_cs]

    # batch: divisible and not
    for batch, ndim in ((256, 2), (32, 3), (1, 2), (12, 3)):
        assert _norm(S.batch_spec(mesh, batch, ndim)) == _norm(
            tuple(RS.batch_spec(ref_mesh, batch, ndim)))


@pytest.fixture
def fake_group():
    """A fake process group of 8 ranks for the test, stopped after it."""
    meshmod.start_process_group("fake", world_size=8)
    try:
        yield meshmod.make_host_mesh((2, 4), ("data", "model"), device="cpu")
    finally:
        torch.distributed.destroy_process_group()


@pytest.mark.parametrize("arch", ["qwen3-14b", "deepseek-v2-lite-16b", "zamba2-1.2b"])
def test_dtensor_local_shapes_follow_the_specs(fake_group, arch):
    from torch._subclasses.fake_tensor import FakeTensorMode

    mesh = fake_group
    cfg = get_smoke_config(arch)
    with FakeTensorMode():
        shapes = M.param_shapes(cfg)
        specs = S.param_specs(shapes, cfg, mesh)
        model = steps_mod.distribute_model(
            M.param_shapes(cfg), steps_mod.param_shardings(shapes, cfg, mesh),
            make=S.empty_dtensor)
        for name, p in model.named_parameters():
            want = list(p.shape)
            for d, entry in enumerate(specs[name]):
                for ax in ((entry,) if isinstance(entry, str) else (entry or ())):
                    want[d] //= mesh.size(mesh.mesh_dim_names.index(ax))
            assert list(p.to_local().shape) == want, (name, specs[name])
        cache = steps_mod.sharded_cache(cfg, 8, 2048, torch.bfloat16, mesh)
        for seg, shp in zip(cache, M.cache_shapes(cfg, 8, 2048)):
            for leaf, ref in zip(M.cache_leaves(seg), M.cache_leaves(shp)):
                assert tuple(leaf.shape) == tuple(ref.shape)
                assert leaf.to_local().numel() * np.prod(
                    [mesh.size(i) for i, pl in enumerate(leaf.placements) if pl.is_shard()]
                ) == ref.numel()


def test_placements_of_a_multi_axis_entry():
    """("pod", "data") on a dim shards it over both mesh dims, pod outer."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = meshmod.AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    assert S.placements((("pod", "data"), None, "model"), mesh) == (Shard(0), Shard(0), Shard(2))
    assert S.placements((None, None), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError):
        S.placements((("data", "pod"),), mesh)
    # to_shardings keeps a tree's structure, a Sharding at every spec
    tree = S.to_shardings({"a": [(None, "model")], "b": [(("pod", "data"),)]}, mesh)
    assert tree["a"][0] == S.Sharding(mesh, (Replicate(), Replicate(), Shard(1)))
    assert tree["b"][0].placements == (Shard(0), Shard(0), Replicate())
