"""The port's int8 gradient compression against ``repro``'s, bit for bit:
quantize/dequantize (round half to even in both, checked at a tie), ten
steps of error feedback on a seeded tree, and the pod all-reduce on a
1-rank gloo group against JAX's ``shard_map`` over a 1-device "pod" axis."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AxisType, PartitionSpec

from repro.optim import compress as jc
from repro_torch.optim import (
    compressed_psum_pod,
    dequantize_int8,
    error_feedback_update,
    quantize_int8,
)

RNG = np.random.default_rng(11)


def _tree():
    return {"a": RNG.normal(0, 1, (8, 16)).astype(np.float32),
            "b": {"c": RNG.normal(0, 0.01, (33,)).astype(np.float32),
                  "d": RNG.normal(0, 5, (3, 4, 5)).astype(np.float32)}}


def _eq(t, a):
    np.testing.assert_array_equal(t.numpy(), np.asarray(a))


def test_quantize_matches_jax_bit_for_bit_with_ties_to_even():
    # max |x| = 127 makes the scale 1 + 1e-12 = 1.0 in f32: x/scale = x, so
    # 0.5, 1.5, 2.5 and -2.5 are exact ties
    x = np.array([127.0, 0.5, 1.5, 2.5, -2.5, -0.5, 3.25, -127.0], np.float32)
    for arr in (x, RNG.normal(0, 3, (1000,)).astype(np.float32)):
        qt, st = quantize_int8(torch.from_numpy(arr))
        qj, sj = jc.quantize_int8(jnp.asarray(arr))
        assert qt.dtype == torch.int8
        _eq(qt, qj)
        assert st.item() == float(sj)
        _eq(dequantize_int8(qt, st), jc.dequantize_int8(qj, sj))
    assert quantize_int8(torch.from_numpy(x))[0][1:5].tolist() == [0, 2, 2, -2]


def test_error_feedback_matches_jax_over_ten_steps():
    tree = _tree()
    jr = jax.tree.map(jnp.zeros_like, tree)
    tr = {"a": torch.zeros(8, 16), "b": {"c": torch.zeros(33), "d": torch.zeros(3, 4, 5)}}
    for _ in range(10):
        g = jax.tree.map(lambda a: (a + RNG.normal(0, 0.1, a.shape)).astype(np.float32), tree)
        jg, jr = jc.error_feedback_update(jax.tree.map(jnp.asarray, g), jr)
        tg, tr = error_feedback_update(jax.tree.map(torch.from_numpy, g), tr)
        for path, want in jax.tree_util.tree_flatten_with_path(jg)[0]:
            keys = [p.key for p in path]
            got = tg
            res = tr
            wres = jr
            for k in keys:
                got, res, wres = got[k], res[k], wres[k]
            _eq(got, want)
            _eq(res, wres)


@pytest.fixture
def gloo_world_of_one():
    assert not dist.is_initialized()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    yield
    dist.destroy_process_group()


def test_compressed_psum_over_a_one_rank_pod_matches_jax_shard_map(gloo_world_of_one):
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((1, 1, 1), ("pod", "data", "model"), "cpu")
    tree = _tree()
    jmesh = jax.make_mesh((1,), ("pod",), axis_types=(AxisType.Auto,))
    jfn = jax.shard_map(lambda t: jc.compressed_psum_pod(t, "pod"), mesh=jmesh,
                        in_specs=PartitionSpec(), out_specs=PartitionSpec())
    want = jfn(jax.tree.map(jnp.asarray, tree))
    got = compressed_psum_pod(jax.tree.map(torch.from_numpy, tree), mesh)
    for path, w in jax.tree_util.tree_flatten_with_path(want)[0]:
        g = got
        for p in path:
            g = g[p.key]
        _eq(g, w)
        assert g.dtype == torch.float32
    # one pod: the mean of one rank is that rank's dequantized leaf
    leaf = torch.from_numpy(tree["a"])
    assert torch.equal(compressed_psum_pod({"a": leaf}, mesh)["a"],
                       dequantize_int8(*quantize_int8(leaf)))
