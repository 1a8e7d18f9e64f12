"""The port's sharding rules against ``repro``'s: for every leaf of every
config (parameters, the decode cache, the inputs of each shape kind),
under the train rules and the decode rules (normal and long context, with
expert parallelism on and off), on the two production meshes, the port's
``spec_for`` gives JAX's ``PartitionSpec``. Shapes only: no parameter is
initialised. Also the port's ``Model`` specs and axes against JAX's, and
the mesh helpers on a world of one."""
import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import SHAPES as JAX_SHAPES
from repro.models import build_model as jax_build_model
from repro.runtime import sharding as jsh
from repro_torch.configs import ARCHS, SHAPES
from repro_torch.launch import mesh as tmesh
from repro_torch.models import build_model
from repro_torch.runtime import sharding as tsh


class _FakeMesh:
    def __init__(self, shape):
        self.shape = shape


MESHES = {False: _FakeMesh({"data": 16, "model": 16}),
          True: _FakeMesh({"pod": 2, "data": 16, "model": 16})}
RULE_SETS = ("train", "decode", "decode_long", "decode_no_ep")


def _rules(mod, rule_set, multi_pod, cfg):
    n_exp = cfg.moe.n_experts if cfg.moe else 0
    if rule_set == "train":
        return mod.train_rules(multi_pod, cfg.family)
    if rule_set == "decode_no_ep":
        return mod.decode_rules(multi_pod, False, cfg.family, 0)
    return mod.decode_rules(multi_pod, rule_set == "decode_long", cfg.family, n_exp)


def _jax_pairs(shapes, axes):
    is_sds = lambda x: isinstance(x, jax.ShapeDtypeStruct)  # noqa: E731
    flat, treedef = jax.tree.flatten(shapes, is_leaf=is_sds)
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(shapes, is_leaf=is_sds)[0]]
    return list(zip(paths, flat, treedef.flatten_up_to(axes)))


def _port_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v for k in sorted(tree)
                for k2, v in _port_leaves(tree[k], f"{prefix}['{k}']").items()}
    return {prefix: tree}


@pytest.mark.parametrize("rule_set", RULE_SETS)
@pytest.mark.parametrize("arch", sorted(JAX_ARCHS))
def test_spec_for_equals_jax_on_every_leaf(arch, rule_set):
    jcfg, tcfg = JAX_ARCHS[arch], ARCHS[arch]
    jm, tm = jax_build_model(jcfg), build_model(tcfg, device="cpu")
    checked = 0
    for multi_pod, mesh in MESHES.items():
        jrules = _rules(jsh, rule_set, multi_pod, jcfg)
        trules = _rules(tsh, rule_set, multi_pod, tcfg)
        assert trules == jrules
        trees = [(jm.param_specs(), jm.param_axes(),
                  tm.param_specs(), tm.param_axes())]
        for name, shape in JAX_SHAPES.items():
            kind = "decode" if shape.kind == "decode" else shape.kind
            if (kind == "train") != (rule_set == "train"):
                continue
            trees.append((jm.input_specs(shape), jsh.input_axes(jcfg, kind),
                          tm.input_specs(SHAPES[name]), tsh.input_axes(tcfg, kind)))
        for jshapes, jaxes, tshapes, taxes in trees:
            tleaves = _port_leaves(tshapes)
            taxes_leaves = {}
            tsh.map_tree(lambda s, a: taxes_leaves.setdefault(id(s), a), tshapes, taxes)
            for path, sds, ax in _jax_pairs(jshapes, jaxes):
                t = tleaves[path]
                assert tuple(t.shape) == tuple(sds.shape), path
                assert taxes_leaves[id(t)] == tuple(ax), path
                want = jsh.spec_for(sds.shape, ax, jrules, mesh)
                got = tsh.spec_for(t.shape, taxes_leaves[id(t)], trules, mesh)
                assert tuple(got) == tuple(want), (path, got, want)
                checked += 1
    assert checked > 0


@pytest.mark.parametrize("arch", sorted(JAX_ARCHS))
def test_model_specs_and_axes_equal_jax(arch):
    """param_specs/param_axes, cache_specs and input_specs of every shape:
    same keys, shapes, dtypes and axes; model_flops_per_token equal."""
    jm, tm = jax_build_model(JAX_ARCHS[arch]), build_model(ARCHS[arch], device="cpu")

    def flat_j(tree):
        return {jax.tree_util.keystr(p): v for p, v in
                jax.tree_util.tree_flatten_with_path(
                    tree, is_leaf=lambda x: isinstance(x, jax.ShapeDtypeStruct))[0]}

    pairs = [(jm.param_specs(), tm.param_specs())]
    pairs += [(jm.input_specs(s), tm.input_specs(SHAPES[n])) for n, s in JAX_SHAPES.items()]
    pairs.append((jm.cache_specs(3, 40), tm.cache_specs(3, 40)))
    for jtree, ttree in pairs:
        j, t = flat_j(jtree), _port_leaves(ttree)
        assert sorted(j) == sorted(t)
        for k in j:
            assert t[k].device.type == "meta"
            assert tuple(t[k].shape) == tuple(j[k].shape), k
            assert str(t[k].dtype).removeprefix("torch.") == str(np.dtype(j[k].dtype)), k
    jax_axes = jax.tree_util.tree_flatten_with_path(
        jm.param_axes(), is_leaf=lambda x: isinstance(x, tuple))[0]
    taxes = _port_leaves(tm.param_axes())
    assert {jax.tree_util.keystr(p): tuple(a) for p, a in jax_axes} == taxes
    assert tm.model_flops_per_token() == jm.model_flops_per_token()


def test_rules_degrade_and_never_reuse_an_axis():
    mesh = {"data": 16, "model": 16}
    rules = tsh.train_rules(False)
    assert tsh.spec_for((262144, 3840), ("vocab", "embed"), rules, mesh) == \
        tsh.PartitionSpec("model", None)
    assert tsh.spec_for((51865, 384), ("vocab", "embed"), rules, mesh) == \
        tsh.PartitionSpec(None, None)
    rules = {**rules, "x": "model", "y": "model"}
    assert tsh.spec_for((64, 64), ("x", "y"), rules, mesh) == tsh.PartitionSpec("model", None)
    moe = tsh.base_rules(False, family="moe")
    assert tsh.spec_for((8, 6144, 16384), ("experts", "embed", "ff"), moe,
                        _FakeMesh(mesh))[2] == ("data", "model")


@pytest.fixture
def world_of_one():
    assert not dist.is_initialized()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def test_host_mesh_and_placements_on_a_world_of_one(world_of_one):
    with pytest.raises(ValueError, match="512 ranks"):
        tmesh.make_production_mesh(multi_pod=True, device="cpu")
    with pytest.raises(ValueError, match="256 ranks"):
        tmesh.make_production_mesh(device="cpu")
    mesh = tmesh.make_host_mesh("cpu")
    assert tuple(mesh.mesh_dim_names) == ("data", "model")
    assert tuple(mesh.shape) == (1, 1) and mesh.device_type == "cpu"
    assert tmesh.mesh_device_count(mesh) == 1
    assert tmesh.mesh_device_count(MESHES[True]) == 512
    assert dict(tsh.axis_sizes(mesh)) == {"data": 1, "model": 1}
    assert tsh.placements(("model", None), mesh) == (Replicate(), Shard(0))
    assert tsh.placements((("data", "model"), None), mesh) == (Shard(0), Shard(0))
    with pytest.raises(ValueError, match="mesh order"):
        tsh.placements((("model", "data"),), mesh)
    # the world exists now: a mesh of another size or backend is refused
    with pytest.raises(ValueError, match="needs 4 ranks"):
        tmesh.make_mesh((2, 2), ("data", "model"), "cpu")
    full = torch.arange(12.0).reshape(3, 4)
    sh = tsh.shardings_for_tree({"w": full}, {"w": ("embed", "heads")},
                                tsh.train_rules(False), mesh)
    placed = tsh.shard_tree({"w": full}, sh)
    assert placed["w"].placements == (Replicate(), Shard(1))
    assert torch.equal(tsh.unshard_tree(placed)["w"], full)
