"""The port's model primitives and schema against the JAX package's.

Same numpy-seeded inputs through both; tolerances of tests/test_kernels.py
(f32 2e-3, bf16 2e-2).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.models import build_model as jax_build_model
from repro.models import layers as jl
from repro_torch.configs import ARCHS, get_config
from repro_torch.convert import tensor_from_numpy
from repro_torch.models import build_model
from repro_torch.models import layers as tl
from repro_torch.models.layers import P, init_params

RNG = np.random.default_rng(7)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
ARCH_NAMES = sorted(ARCHS)


def _tol(name):
    return dict(rtol=2e-2, atol=2e-2) if name == "bfloat16" \
        else dict(rtol=2e-3, atol=2e-3)


def _pair(a, name):
    j = jnp.asarray(a, DTYPES[name][0])
    return j, tensor_from_numpy(np.asarray(j), "cpu")


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


@pytest.mark.parametrize("fraction", [1.0, 0.5])
@pytest.mark.parametrize("name", ["float32", "bfloat16"])
@pytest.mark.parametrize("pos_shape", ["batched", "shared"])
def test_apply_rope_matches_jax(fraction, name, pos_shape):
    B, S, H, D = 2, 12, 3, 32
    xj, xt = _pair(RNG.normal(0, 1, (B, S, H, D)), name)
    pos = (RNG.integers(0, 5000, (B, S)) if pos_shape == "batched"
           else np.arange(S) + 100)
    got = tl.apply_rope(xt, torch.from_numpy(pos), fraction=fraction, theta=1e6)
    want = jl.apply_rope(xj, jnp.asarray(pos), fraction=fraction, theta=1e6)
    assert got.dtype == xt.dtype
    np.testing.assert_allclose(_np(got), _np(want), **_tol(name))
    if fraction < 1.0:      # the unrotated half passes through untouched
        assert torch.equal(got[..., D // 2:], xt[..., D // 2:])


@pytest.mark.parametrize("name", ["float32", "bfloat16"])
def test_qkv_project_with_bias_matches_jax(name):
    B, S, d, H, Hkv, hd = 2, 5, 64, 4, 2, 16
    jp, tp = {}, {}
    for k, shape in {"wq": (d, H * hd), "wk": (d, Hkv * hd), "wv": (d, Hkv * hd),
                     "bq": (H * hd,), "bk": (Hkv * hd,), "bv": (Hkv * hd,)}.items():
        jp[k], tp[k] = _pair(RNG.normal(0, 0.2, shape), name)
    xj, xt = _pair(RNG.normal(0, 1, (B, S, d)), name)
    for got, want in zip(tl.qkv_project(xt, tp, H, Hkv, hd),
                         jl.qkv_project(xj, jp, H, Hkv, hd)):
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(_np(got), _np(want), **_tol(name))


@pytest.mark.parametrize("name", ["float32", "bfloat16"])
def test_swiglu_matches_jax(name):
    d, f = 64, 96
    xj, xt = _pair(RNG.normal(0, 1, (2, 3, d)), name)
    ws = [_pair(RNG.normal(0, 0.15, s), name) for s in ((d, f), (d, f), (f, d))]
    got = tl.swiglu(xt, *(t for _, t in ws))
    want = jl.swiglu(xj, *(j for j, _ in ws))
    np.testing.assert_allclose(_np(got), _np(want), **_tol(name))


@pytest.mark.parametrize("name", ["float32", "bfloat16"])
def test_layers_rmsnorm_matches_jax(name):
    """layers.rmsnorm rounds to x's dtype before the scale multiply, as JAX's."""
    xj, xt = _pair(RNG.normal(0, 1, (3, 7, 128)), name)
    sj, st = _pair(RNG.normal(1, 0.1, (128,)), name)
    got = tl.rmsnorm(xt, st, 1e-6)
    want = jl.rmsnorm(xj, sj, 1e-6)
    np.testing.assert_allclose(_np(got), _np(want), **_tol(name))


def _shapes(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_shapes(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = tuple(v.shape)
    return out


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_specs_match_jax(arch):
    """Every arch at full width, of all six families: same key paths, shapes
    and dtype, built on the meta device (no allocation)."""
    model = build_model(get_config(arch), device="cpu")
    specs = model.param_specs()
    leaves = jax.tree.leaves(specs)
    assert all(t.device.type == "meta" and t.dtype == torch.bfloat16 for t in leaves)
    jspecs = jax_build_model(JAX_ARCHS[arch]).param_specs()
    assert _shapes(specs) == _shapes(jspecs)


def test_full_qwen_param_count_matches_config():
    cfg = get_config("qwen1.5-0.5b")
    assert build_model(cfg, device="cpu").n_params() == cfg.param_count() == \
        JAX_ARCHS["qwen1.5-0.5b"].param_count()


def test_full_qwen3_moe_param_count_matches_config():
    """30.53 B parameters, 61.1 GB in bf16: it fits one 80 GB card."""
    cfg = get_config("qwen3-moe-30b-a3b")
    n = build_model(cfg, device="cpu").n_params()
    assert n == cfg.param_count() == JAX_ARCHS["qwen3-moe-30b-a3b"].param_count()
    assert 30.5e9 < n < 30.6e9


def test_chunked_init_keeps_shape_dtype_and_fan_in_std(monkeypatch):
    """A stacked expert leaf (layers, pattern, experts, d, ff) drawn in
    blocks of rows: the shape and dtype of the leaf, the fan-in std
    (shape[-2]) of a N(0,1) truncated at ±2σ within 5 %, blocks that differ
    from each other, and the same values as one draw whenever the leaf fits
    one block."""
    p = P((3, 1, 4, 96, 40), ("layers", "pattern", "experts", "embed", "ff"))
    cpu = torch.device("cpu")
    whole = tl._init_leaf(p, torch.Generator().manual_seed(5), torch.float32, cpu)
    assert tl.INIT_CHUNK >= whole.numel()
    monkeypatch.setattr(tl, "INIT_CHUNK", whole.numel())
    assert torch.equal(tl._init_leaf(p, torch.Generator().manual_seed(5), torch.float32,
                                     cpu), whole)
    monkeypatch.setattr(tl, "INIT_CHUNK", 1000)              # 25 rows of 40 a block
    leaf = tl._init_leaf(p, torch.Generator().manual_seed(5), torch.bfloat16, cpu)
    assert leaf.shape == p.shape and leaf.dtype == torch.bfloat16
    std = 1 / np.sqrt(96)
    w = leaf.float().numpy()
    assert abs(w.std() / std - 0.8796) < 0.05 * 0.8796
    assert np.abs(w).max() <= 2 * std * (1 + 2 ** -8)
    rows = w.reshape(-1, 40)
    assert not np.array_equal(rows[:25], rows[25:50])


def test_init_params_truncated_normal_fan_in_from_generator():
    schema = {"w": P((400, 300), ("embed", "ff")), "b": P((300,), ("ff",), "zeros"),
              "n": P((300,), ("ff",), "ones")}
    a = init_params(schema, torch.Generator().manual_seed(3), torch.float32)
    b = init_params(schema, torch.Generator().manual_seed(3), torch.float32)
    c = init_params(schema, torch.Generator().manual_seed(4), torch.float32)
    assert torch.equal(a["w"], b["w"]) and not torch.equal(a["w"], c["w"])
    std = 1 / np.sqrt(400)                       # fan-in = shape[-2]
    w = a["w"].numpy()
    assert np.abs(w).max() <= 2 * std + 1e-7     # truncated at ±2σ
    # std of a N(0,1) truncated to ±2 is 0.8796
    assert abs(w.std() / std - 0.8796) < 0.02
    assert torch.equal(a["b"], torch.zeros(300)) and torch.equal(a["n"], torch.ones(300))
    bf = init_params(schema, torch.Generator().manual_seed(3), torch.bfloat16)
    assert bf["w"].dtype == torch.bfloat16
