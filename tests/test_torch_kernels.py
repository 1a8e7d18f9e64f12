"""The port's kernels: plain PyTorch versions against the JAX Pallas kernels
(interpret mode) and oracles, on the same numpy-seeded inputs.

Tolerances are those of tests/test_kernels.py: f32 2e-3, bf16 2e-2. The
CUDA kernels themselves run only on a card: tests/test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.flash_attention import flash_attention_fwd as jax_flash_fwd
from repro.kernels.rmsnorm import rmsnorm_pallas
from repro.models.layers import attention as jax_attention
from repro_torch.convert import tensor_from_numpy
from repro_torch.kernels import build, ops
from repro_torch.kernels.flash_attention import (
    flash_attention_cuda,
    flash_attention_plain,
)
from repro_torch.kernels.rmsnorm import rmsnorm_cuda, rmsnorm_plain

RNG = np.random.default_rng(42)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
FLASH_CASES = [
    (128, 128, 4, 4, 64, True, 0),      # MHA causal
    (128, 128, 8, 2, 64, True, 0),      # GQA 4:1
    (256, 256, 4, 1, 32, True, 64),     # MQA + sliding window
    (64, 192, 4, 2, 64, False, 0),      # cross-length, bidirectional
    (96, 96, 2, 2, 128, True, 32),      # non-pow2 seq, window
]


def _tol(name):
    return dict(rtol=2e-2, atol=2e-2) if name == "bfloat16" \
        else dict(rtol=2e-3, atol=2e-3)


def _pair(a: np.ndarray, name: str):
    """The same values as a JAX array and a CPU tensor of dtype ``name``."""
    j = jnp.asarray(a, DTYPES[name][0])
    return j, tensor_from_numpy(np.asarray(j), "cpu")


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


@pytest.mark.parametrize("shape", [(1, 7, 64), (4, 33, 128), (2, 256, 512)])
@pytest.mark.parametrize("name", ["float32", "bfloat16"])
def test_rmsnorm_plain_matches_pallas(shape, name):
    xj, xt = _pair(RNG.normal(0, 1, shape), name)
    sj, st = _pair(RNG.normal(1, 0.1, shape[-1:]), name)
    got = rmsnorm_plain(xt, st)
    assert got.dtype == xt.dtype
    np.testing.assert_allclose(_np(got), _np(rmsnorm_pallas(xj, sj, interpret=True)),
                               **_tol(name))
    np.testing.assert_allclose(_np(got), _np(ref.rmsnorm_ref(xj, sj)), **_tol(name))


@pytest.mark.parametrize("S,T,Hq,Hkv,D,causal,window", FLASH_CASES)
@pytest.mark.parametrize("name", ["float32", "bfloat16"])
def test_flash_plain_matches_pallas(S, T, Hq, Hkv, D, causal, window, name):
    qj, qt = _pair(RNG.normal(0, 1, (2, S, Hq, D)), name)
    kj, kt = _pair(RNG.normal(0, 1, (2, T, Hkv, D)), name)
    vj, vt = _pair(RNG.normal(0, 1, (2, T, Hkv, D)), name)
    want_o, want_lse = jax_flash_fwd(qj, kj, vj, causal=causal, window=window,
                                     block_q=64, block_k=64, interpret=True)
    o, lse = flash_attention_plain(qt, kt, vt, causal=causal, window=window)
    assert o.shape == (2, S, Hq, D) and o.dtype == qt.dtype
    assert lse.shape == (2 * Hq, S) and lse.dtype == torch.float32
    np.testing.assert_allclose(_np(o), _np(want_o), **_tol(name))
    np.testing.assert_allclose(_np(lse), _np(want_lse), **_tol(name))


@pytest.mark.parametrize("name", ["float32", "bfloat16"])
def test_flash_plain_decode_kv_len_matches_reference(name):
    """Decode shape: S=1 against 48 cache slots with a valid length per row."""
    B, T, Hq, Hkv, D = 3, 48, 4, 2, 32
    lens = [5, 48, 17]
    qj, qt = _pair(RNG.normal(0, 1, (B, 1, Hq, D)), name)
    kj, kt = _pair(RNG.normal(0, 1, (B, T, Hkv, D)), name)
    vj, vt = _pair(RNG.normal(0, 1, (B, T, Hkv, D)), name)
    o, lse = flash_attention_plain(qt, kt, vt, causal=False, window=0,
                                   kv_len=torch.tensor(lens, dtype=torch.int32))
    for b, n in enumerate(lens):
        want = jax_attention(qj[b:b + 1], kj[b:b + 1], vj[b:b + 1], causal=False,
                             kv_len=jnp.int32(n))
        np.testing.assert_allclose(_np(o[b:b + 1]), _np(want), **_tol(name))
        # the same row against a cache cut to its valid prefix: no kv_len
        o_cut, lse_cut = flash_attention_plain(qt[b:b + 1], kt[b:b + 1, :n],
                                               vt[b:b + 1, :n], causal=False, window=0)
        np.testing.assert_allclose(_np(o[b:b + 1]), _np(o_cut), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(_np(lse[b * Hq:(b + 1) * Hq]), _np(lse_cut),
                                   rtol=1e-6, atol=1e-6)


def test_flash_plain_rows_without_a_valid_key_are_zero():
    """Window 4 with kv_len 6: query rows from 9 on see no valid key."""
    q, k, v = (torch.randn(2, 16, 2, 32) for _ in range(3))
    kv_len = torch.tensor([16, 6], dtype=torch.int32)
    o, lse = flash_attention_plain(q, k, v, causal=True, window=4, kv_len=kv_len)
    assert torch.equal(o[1, 9:], torch.zeros_like(o[1, 9:]))
    assert torch.all(lse.view(2, 2, 16)[1, :, 9:] == -1e30)
    assert torch.all(o[1, :9].abs().sum(-1) > 0) and torch.all(lse[:, :9] > -1e29)
    full, _ = flash_attention_plain(q[:1], k[:1], v[:1], causal=True, window=4)
    torch.testing.assert_close(o[:1], full, rtol=0, atol=0)


def test_flash_plain_rejects_empty_kv_len():
    q = torch.zeros(2, 1, 2, 32)
    k = torch.zeros(2, 8, 2, 32)
    with pytest.raises(ValueError, match="at least one valid key"):
        flash_attention_plain(q, k, k, causal=False, window=0,
                              kv_len=torch.tensor([3, 0], dtype=torch.int32))
    with pytest.raises(ValueError, match="int32"):
        flash_attention_plain(q, k, k, causal=False, window=0,
                              kv_len=torch.tensor([3, 1]))


def test_ops_on_cpu_take_plain_path_and_count_nothing():
    ops.reset_launch_counts()
    x = torch.randn(3, 5, 64, dtype=torch.float32)
    s = torch.randn(64)
    torch.testing.assert_close(ops.rmsnorm(x, s, 1e-6), rmsnorm_plain(x, s, 1e-6),
                               rtol=0, atol=0)
    q, k = torch.randn(2, 16, 4, 32), torch.randn(2, 16, 2, 32)
    got = ops.flash_attention_fwd(q, k, k, causal=True, window=8)
    want = flash_attention_plain(q, k, k, causal=True, window=8)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert ops.launch_counts() == {"rmsnorm": 0, "flash_fwd": 0}


def test_ops_reject_devices_without_a_kernel():
    x = torch.empty(2, 64, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ops.rmsnorm(x, torch.empty(64, device="meta"))
    q = torch.empty(1, 4, 2, 32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ops.flash_attention_fwd(q, q, q, causal=True, window=0)


def test_cuda_wrappers_refuse_cpu_tensors():
    """A CPU tensor never reaches the CUDA wrappers' build or launch."""
    x = torch.randn(4, 64)
    with pytest.raises(ValueError, match="CUDA"):
        rmsnorm_cuda(x, torch.ones(64))
    q = torch.randn(1, 4, 2, 64)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q, q, q, causal=True, window=0)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_cuda(torch.randn(1, 4, 2, 48), torch.randn(1, 4, 2, 48),
                             torch.randn(1, 4, 2, 48), causal=True, window=0)
    assert ops.launch_counts() == {"rmsnorm": 0, "flash_fwd": 0}


def test_build_hash_covers_every_source():
    names = {p.name for p in build.sources()}
    assert {"flash_fwd.cu", "rmsnorm.cu", "errors.cu"} <= names
    assert build.source_hash() == build.source_hash()
    assert set(build.SIGNATURES) == {"repro_rmsnorm_f32", "repro_rmsnorm_bf16",
                                     "repro_flash_fwd_f32", "repro_flash_fwd_bf16"}
