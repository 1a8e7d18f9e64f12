"""The port's kernels: plain PyTorch versions against the JAX Pallas kernels
(interpret mode) and oracles, on the same numpy-seeded inputs.

Tolerances are those of tests/test_kernels.py: f32 2e-3, bf16 2e-2. The
CUDA kernels themselves run only on a card: tests/test_torch_cuda.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.flash_attention import flash_attention_bwd as jax_flash_bwd
from repro.kernels.flash_attention import flash_attention_fwd as jax_flash_fwd
from repro.kernels.moe_gmm import moe_gmm_pallas
from repro.kernels.rmsnorm import rmsnorm_pallas
from repro.models.layers import attention as jax_attention
from repro_torch.configs import ARCHS
from repro_torch.convert import tensor_from_numpy
from repro_torch.kernels import build, moe_gmm, ops
from repro_torch.kernels.flash_attention import (
    DECODE_CHUNK,
    HEAD_DIMS,
    _decode_plan,
    flash_decode_split_plain,
    flash_attention_bwd_cuda,
    flash_attention_bwd_plain,
    flash_attention_cuda,
    flash_attention_plain,
)
from repro_torch.kernels.moe_gmm import moe_gmm_cuda, moe_gmm_plain
from repro_torch.kernels.rmsnorm import rmsnorm_cuda, rmsnorm_plain
from repro_torch.kernels.ssd_scan import ssd_scan_cuda, ssd_scan_plain

RNG = np.random.default_rng(42)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
FLASH_CASES = [
    (128, 128, 4, 4, 64, True, 0),      # MHA causal
    (128, 128, 8, 2, 64, True, 0),      # GQA 4:1
    (256, 256, 4, 1, 32, True, 64),     # MQA + sliding window
    (64, 192, 4, 2, 64, False, 0),      # cross-length, bidirectional
    (96, 96, 2, 2, 128, True, 32),      # non-pow2 seq, window
    (96, 96, 4, 4, 80, True, 0),        # zamba2's shared block: D = 80
    (64, 64, 4, 2, 96, True, 0),        # phi-3-vision: D = 96
    (128, 128, 4, 2, 256, True, 48),    # gemma3: GQA 2:1, D = 256, a local window
]
# the backward cases of tests/test_kernels.py, then D = 96 and D = 256
FLASH_BWD_CASES = [
    (128, 128, 4, 2, 32, True, 0),
    (128, 128, 4, 4, 64, True, 48),
    (64, 192, 4, 1, 32, False, 0),
    (64, 64, 4, 1, 96, True, 0),
    (128, 128, 4, 2, 256, True, 48),
    (32, 64, 2, 2, 256, False, 0),
]
# the grouped-GEMM cases of tests/test_kernels.py, then ragged C: 1, 8 and
# 40 tokens per expert (one slot, a decode round of 8 slots, a 511-token
# admission of qwen3-moe-30b-a3b); then the qwen3-moe smoke layer's widths
# (8 experts, d 128, ff 64), gate/up and down, at C = 40, 82 (264 tokens)
# and 100: no multiple of the 64-row tile; then decode shapes: C = 16, the
# most the decode kernel takes, and a D and F that meet TMA's rule but no
# tile's width
GMM_CASES = [(2, 64, 128, 96), (8, 128, 64, 256), (3, 96, 160, 32),
             (4, 1, 128, 64), (4, 8, 128, 64), (4, 40, 128, 64),
             (8, 40, 128, 64), (8, 40, 64, 128), (8, 82, 128, 64), (8, 100, 64, 128),
             (4, 16, 128, 64), (3, 8, 200, 72)]
NO_LAUNCHES = {"rmsnorm": 0, "flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
               "moe_gmm": 0, "moe_gmm_dx": 0, "moe_gmm_dw": 0, "ssd_scan": 0,
               "ssd_scan_bwd": 0}


def _tol(name):
    return dict(rtol=2e-2, atol=2e-2) if name == "bfloat16" \
        else dict(rtol=2e-3, atol=2e-3)


def _pair(a: np.ndarray, name: str):
    """The same values as a JAX array and a CPU tensor of dtype ``name``."""
    j = jnp.asarray(a, DTYPES[name][0])
    return j, tensor_from_numpy(np.asarray(j), "cpu")


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


@pytest.mark.parametrize("shape", [(1, 7, 64), (4, 33, 128), (2, 256, 512),
                                   (3, 5, 100), (2, 4, 1001)])
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


# the split-KV decode: (B, S, T, Hq, Hkv, D, causal, window, kv_len) at
# 64-key chunks, so that kv_len falls at 1, on chunk edges (63, 64, 65, 128,
# 129) and at T, and empty chunks occur; GQA 8:1, 2:1 and 1:1, S = 1..4,
# every head dim. The last case has a row without a valid key (window 1,
# kv_len 2: row 3 sees key 3 only).
SPLIT_CHUNK = 64
SPLIT_CASES = [
    (3, 1, 300, 8, 1, 32, False, 0, [1, 64, 300]),
    (3, 1, 257, 4, 2, 64, False, 0, [63, 65, 257]),
    (2, 3, 130, 4, 4, 80, True, 0, [130, 129]),
    (2, 4, 200, 2, 1, 128, True, 2, [200, 128]),
    (2, 4, 70, 2, 2, 32, True, 1, [70, 2]),
]


@pytest.mark.parametrize("T", [1, 63, 64, 65, 255, 256, 257, 300, 2048, 2049])
def test_decode_plan_puts_every_key_in_one_chunk(T):
    chunk, splits = _decode_plan(T)
    assert chunk == DECODE_CHUNK and chunk % 128 == 0  # 4 warps x 32-key steps
    assert (splits - 1) * chunk < T <= splits * chunk    # no chunk starts past T
    owner = torch.zeros(T, dtype=torch.int64)
    for i in range(splits):
        owner[i * chunk:(i + 1) * chunk] += 1
    assert bool((owner == 1).all())


@pytest.mark.parametrize("case", SPLIT_CASES)
@pytest.mark.parametrize("name", ["float32", "bfloat16"])
def test_flash_decode_split_plain_matches_plain_and_jax(case, name):
    B, S, T, Hq, Hkv, D, causal, window, lens = case
    qj, qt = _pair(RNG.normal(0, 1, (B, S, Hq, D)), name)
    kj, kt = _pair(RNG.normal(0, 1, (B, T, Hkv, D)), name)
    vj, vt = _pair(RNG.normal(0, 1, (B, T, Hkv, D)), name)
    kv_len = torch.tensor(lens, dtype=torch.int32)
    o, lse = flash_decode_split_plain(qt, kt, vt, causal=causal, window=window,
                                      kv_len=kv_len, chunk=SPLIT_CHUNK)
    po, plse = flash_attention_plain(qt, kt, vt, causal=causal, window=window,
                                     kv_len=kv_len)
    assert o.dtype == qt.dtype and o.shape == po.shape and lse.shape == plse.shape
    np.testing.assert_allclose(_np(o), _np(po), **_tol(name))
    np.testing.assert_allclose(_np(lse), _np(plse), rtol=2e-3, atol=2e-3)
    # JAX on each row's valid prefix (its kernels take no kv_len): the
    # oracle for O where every query row sees a key
    for b, n in enumerate(lens):
        cut = (slice(b, b + 1), slice(0, n))
        seen = flash_attention_plain(qt[b:b + 1], kt[cut], vt[cut], causal=causal,
                                     window=window)[1] > -1e29
        if bool(seen.all()):
            want = ref.flash_attention_ref(qj[b:b + 1], kj[cut], vj[cut], causal=causal,
                                           window=window)
            np.testing.assert_allclose(_np(o[b:b + 1]), _np(want), **_tol(name))
        else:   # the rows without a key are 0, the others as the oracle's
            empty = ~seen.view(Hq, S).T                       # (S, Hq)
            assert bool((o[b][empty] == 0).all())
            want = ref.flash_attention_ref(qj[b:b + 1], kj[cut], vj[cut], causal=causal,
                                           window=window)
            np.testing.assert_allclose(_np(o[b][~empty]), _np(want[0])[~empty.numpy()],
                                       **_tol(name))


@pytest.mark.parametrize("name", ["float32", "bfloat16"])
def test_flash_decode_split_plain_matches_pallas_without_kv_len(name):
    """Whole cache valid: O and lse against the Pallas kernel (interpret)."""
    B, S, T, Hq, Hkv, D = 2, 2, 192, 4, 1, 64
    qj, qt = _pair(RNG.normal(0, 1, (B, S, Hq, D)), name)
    kj, kt = _pair(RNG.normal(0, 1, (B, T, Hkv, D)), name)
    vj, vt = _pair(RNG.normal(0, 1, (B, T, Hkv, D)), name)
    want_o, want_lse = jax_flash_fwd(qj, kj, vj, causal=False, window=0, block_q=2,
                                     block_k=64, interpret=True)
    o, lse = flash_decode_split_plain(qt, kt, vt, causal=False, window=0, chunk=SPLIT_CHUNK)
    np.testing.assert_allclose(_np(o), _np(want_o), **_tol(name))
    np.testing.assert_allclose(_np(lse), _np(want_lse), **_tol(name))


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
    buf, w = torch.randn(3, 5, 16), torch.randn(3, 16, 8)
    torch.testing.assert_close(ops.moe_gmm(buf, w), moe_gmm_plain(buf, w), rtol=0, atol=0)
    xh, bc = torch.randn(2, 9, 2, 32), torch.randn(2, 9, 1, 16)
    dt, a = torch.rand(2, 9, 2) * 0.1, -torch.rand(2)
    for g, w in zip(ops.ssd_scan(xh, dt, a, bc, bc, chunk=4),
                    ssd_scan_plain(xh, dt, a, bc, bc, chunk=4)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert ops.launch_counts() == NO_LAUNCHES
    assert ops.flash_variant_counts() == {"tc_prefill": 0, "split_decode": 0, "fma": 0}
    assert ops.flash_bwd_variant_counts() == {"flash_bwd_dq": {"tc": 0, "fma": 0},
                                              "flash_bwd_dkv": {"tc": 0, "fma": 0}}
    assert ops.moe_gmm_variant_counts() == {"tc_prefill": 0, "decode": 0, "wmma": 0,
                                            "fma": 0}


def test_ops_reject_devices_without_a_kernel():
    x = torch.empty(2, 64, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ops.rmsnorm(x, torch.empty(64, device="meta"))
    q = torch.empty(1, 4, 2, 32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ops.flash_attention_fwd(q, q, q, causal=True, window=0)
    with pytest.raises(ValueError, match="no kernel"):
        ops.moe_gmm(torch.empty(2, 4, 8, device="meta"), torch.empty(2, 8, 4, device="meta"))


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
    o, lse = flash_attention_plain(q, q, q, causal=True, window=0)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_bwd_cuda(q, q, q, o, lse, o, causal=True, window=0)
    with pytest.raises(ValueError, match="CUDA"):
        moe_gmm_cuda(torch.randn(2, 4, 8), torch.randn(2, 8, 4))
    xh, bc = torch.randn(1, 8, 2, 32), torch.randn(1, 8, 1, 16)
    with pytest.raises(ValueError, match="CUDA"):
        ssd_scan_cuda(xh, torch.rand(1, 8, 2), -torch.rand(2), bc, bc)
    assert ops.launch_counts() == NO_LAUNCHES


ATTENTION_CONFIGS = sorted(name for name, cfg in ARCHS.items() if cfg.n_heads)


@pytest.mark.parametrize("arch", ATTENTION_CONFIGS)
def test_every_config_head_dim_is_taken_by_both_cuda_wrappers(arch):
    """The forward and backward wrappers take the head dim of every config
    with attention: on CPU tensors they get past the head-dim check and
    refuse the device instead (a head dim they do not take raises first)."""
    D = ARCHS[arch].head_dim_
    assert D in HEAD_DIMS
    q = torch.randn(1, 4, 2, D)
    with pytest.raises(ValueError, match="one CUDA device"):
        flash_attention_cuda(q, q, q, causal=True, window=0)
    o, lse = flash_attention_plain(q, q, q, causal=True, window=0)
    with pytest.raises(ValueError, match="one CUDA device"):
        flash_attention_bwd_cuda(q, q, q, o, lse, o, causal=True, window=0)
    bad = torch.randn(1, 4, 2, 48)
    o, lse = flash_attention_plain(bad, bad, bad, causal=True, window=0)
    with pytest.raises(ValueError, match="head dim 48"):
        flash_attention_bwd_cuda(bad, bad, bad, o, lse, o, causal=True, window=0)


def test_build_hash_covers_every_source(tmp_path, monkeypatch):
    names = {p.name for p in build.sources()}
    assert {"flash_fwd.cu", "rmsnorm.cu", "errors.cu"} <= names
    assert build.source_hash() == build.source_hash()
    assert {"flash_bwd.cu", "moe_gmm.cu", "ssd_scan.cu", "ssd_scan_bwd.cu", "hopper.cuh"} <= names
    assert set(build.SIGNATURES) == {
        f"repro_{k}_{t}" for k in ("rmsnorm", "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                                   "moe_gmm", "ssd_scan")
        for t in ("f32", "bf16")} | {
            "repro_flash_decode_bf16", "repro_moe_gmm_bf16_tc", "repro_moe_gmm_bf16_decode",
            "repro_moe_gmm_bwd_bf16_tc", "repro_moe_gmm_bwd_bf16", "repro_moe_gmm_bwd_f32",
            "repro_ssd_scan_bwd_f32", "repro_ssd_scan_bwd_bf16"}
    # a change to any source, the shared header included, changes the hash
    for src in build.sources():
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(build, "CSRC", tmp_path)
    before = build.source_hash()
    for name in ("hopper.cuh", "flash_fwd.cu"):
        path = tmp_path / name
        path.write_text(path.read_text() + "\n// edited\n")
        after = build.source_hash()
        assert after != before, name
        before = after


def _bwd_inputs(S, T, Hq, Hkv, D, name):
    """Numpy-seeded q, k, v, dO as (JAX, torch) pairs of dtype ``name``."""
    return [_pair(RNG.normal(0, 1, shape), name) for shape in
            ((2, S, Hq, D), (2, T, Hkv, D), (2, T, Hkv, D), (2, S, Hq, D))]


@pytest.mark.parametrize("S,T,Hq,Hkv,D,causal,window", FLASH_BWD_CASES)
@pytest.mark.parametrize("name", ["float32", "bfloat16"])
def test_flash_bwd_plain_matches_pallas(S, T, Hq, Hkv, D, causal, window, name):
    """From the same O and lse (JAX's forward), the plain backward gives JAX's
    Pallas backward's dq, dk, dv (interpret mode)."""
    (qj, qt), (kj, kt), (vj, vt), (dj, dt) = _bwd_inputs(S, T, Hq, Hkv, D, name)
    oj, lsej = jax_flash_fwd(qj, kj, vj, causal=causal, window=window, interpret=True)
    want = jax_flash_bwd(qj, kj, vj, oj, lsej, dj, causal=causal, window=window,
                         interpret=True)
    ot = tensor_from_numpy(np.asarray(oj), "cpu")
    lset = tensor_from_numpy(np.asarray(lsej), "cpu")
    got = flash_attention_bwd_plain(qt, kt, vt, ot, lset, dt, causal=causal,
                                    window=window)
    for g, w, ref_t in zip(got, want, (qt, kt, vt)):
        assert g.shape == ref_t.shape and g.dtype == ref_t.dtype
        np.testing.assert_allclose(_np(g), _np(w), **_tol(name))


@pytest.mark.parametrize("S,T,Hq,Hkv,D,causal,window", FLASH_BWD_CASES)
@pytest.mark.parametrize("name", ["float32", "bfloat16"])
def test_flash_function_grad_matches_jax_grad_of_oracle(S, T, Hq, Hkv, D, causal,
                                                         window, name):
    """autograd through ``ops.flash_attention`` (the Function's own backward)
    against ``jax.vjp`` of ``ref.flash_attention_ref`` on the same values in
    f32: the oracle rounds its probabilities to the input dtype."""
    (qj, qt), (kj, kt), (vj, vt), (dj, dt) = _bwd_inputs(S, T, Hq, Hkv, D, name)
    f32 = [x.astype(jnp.float32) for x in (qj, kj, vj, dj)]
    _, vjp = jax.vjp(lambda q, k, v: ref.flash_attention_ref(
        q, k, v, causal=causal, window=window), *f32[:3])
    want = vjp(f32[3])
    leaves = [t.clone().requires_grad_() for t in (qt, kt, vt)]
    o = ops.flash_attention(*leaves, causal=causal, window=window)
    assert o.grad_fn is not None and "FlashAttention" in type(o.grad_fn).__name__
    got = torch.autograd.grad(o, leaves, dt)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), **_tol(name))


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 3), (False, 0)])
def test_flash_function_backward_passes_gradcheck(causal, window):
    """float64: the Function's backward against finite differences of its
    forward (both plain on the CPU), GQA 4:2, S != T."""
    gen = torch.Generator().manual_seed(0)
    S, T = (6, 6) if causal else (5, 7)
    q = torch.randn(1, S, 4, 8, dtype=torch.float64, generator=gen, requires_grad=True)
    k = torch.randn(1, T, 2, 8, dtype=torch.float64, generator=gen, requires_grad=True)
    v = torch.randn(1, T, 2, 8, dtype=torch.float64, generator=gen, requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda q, k, v: ops.flash_attention(q, k, v, causal=causal, window=window),
        (q, k, v))


def test_rmsnorm_function_backward_passes_gradcheck():
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(3, 5, 16, dtype=torch.float64, generator=gen, requires_grad=True)
    s = (1 + 0.1 * torch.randn(16, dtype=torch.float64, generator=gen)).requires_grad_()
    assert torch.autograd.gradcheck(lambda x, s: ops.rmsnorm(x, s, 1e-6), (x, s))
    y = ops.rmsnorm(x, s, 1e-6)
    assert "RMSNorm" in type(y.grad_fn).__name__


@pytest.mark.parametrize("name", ["float32", "bfloat16"])
def test_rmsnorm_function_grad_matches_jax_grad_of_oracle(name):
    xj, xt = _pair(RNG.normal(0, 1, (4, 33, 128)), name)
    sj, st = _pair(RNG.normal(1, 0.1, (128,)), name)
    gj, gt = _pair(RNG.normal(0, 1, (4, 33, 128)), name)
    _, vjp = jax.vjp(lambda x, s: ref.rmsnorm_ref(x, s), xj.astype(jnp.float32),
                     sj.astype(jnp.float32))
    want = vjp(gj.astype(jnp.float32))
    leaves = [t.clone().requires_grad_() for t in (xt, st)]
    got = torch.autograd.grad(ops.rmsnorm(*leaves, 1e-6), leaves, gt)
    for g, w, t in zip(got, want, leaves):
        assert g.dtype == t.dtype
        # ds sums 132 rows: its bf16 rounding is relative to the sum
        np.testing.assert_allclose(_np(g), _np(w), **_tol(name))


def test_function_layer_is_skipped_without_grad():
    """Serving calls: no input requires grad, or grad is off → no Function."""
    q, k = torch.randn(1, 8, 2, 16), torch.randn(1, 8, 2, 16)
    assert ops.flash_attention(q, k, k, causal=True, window=0).grad_fn is None
    x, s = torch.randn(2, 16), torch.ones(16, requires_grad=True)
    with torch.no_grad():
        assert ops.rmsnorm(x, s).grad_fn is None
    assert ops.launch_counts() == NO_LAUNCHES


def test_flash_bwd_refuses_kv_len():
    q = torch.randn(1, 4, 2, 32)
    o, lse = flash_attention_plain(q, q, q, causal=True, window=0)
    with pytest.raises(ValueError, match="kv_len"):
        flash_attention_bwd_cuda(q, q, q, o, lse, o, causal=True, window=0,
                                 kv_len=torch.tensor([4], dtype=torch.int32))


@pytest.mark.parametrize("E,C,D,F", GMM_CASES)
@pytest.mark.parametrize("name", ["float32", "bfloat16"])
def test_moe_gmm_plain_matches_pallas(E, C, D, F, name):
    """The plain grouped GEMM against the Pallas kernel in interpret mode and
    against ``ref.moe_gmm_ref``, with tests/test_kernels.py's tolerances
    (f32 1e-3; bf16 5e-2 relative and 5e-1 absolute: a bf16 output of a
    sum over D products)."""
    bj, bt = _pair(RNG.normal(0, 1, (E, C, D)), name)
    wj, wt = _pair(RNG.normal(0, 0.5, (E, D, F)), name)
    got = moe_gmm_plain(bt, wt)
    assert got.dtype == DTYPES[name][1] and got.shape == (E, C, F)
    tol = dict(rtol=5e-2, atol=5e-1) if name == "bfloat16" else dict(rtol=1e-3, atol=1e-3)
    for want in (moe_gmm_pallas(bj, wj, interpret=True), ref.moe_gmm_ref(bj, wj)):
        np.testing.assert_allclose(_np(got), _np(want), **tol)


@pytest.mark.parametrize("C", [1, 8, 16])
@pytest.mark.parametrize("nan", [False, True])
@pytest.mark.parametrize("name", ["float32", "bfloat16"])
def test_moe_gmm_plain_matches_pallas_with_an_expert_of_zero_rows(C, nan, name):
    """Decode shapes where one expert got no token (its rows all zero), with
    and without a NaN in that expert's w: zero times NaN is NaN, so that
    expert's column is NaN in every row in the Pallas kernel, in
    ``ref.moe_gmm_ref`` and in the plain version alike (the NaNs must fall
    on the same elements), and the rest agrees within the tolerances of
    ``test_moe_gmm_plain_matches_pallas``."""
    E, D, F = 4, 128, 64
    b = RNG.normal(0, 1, (E, C, D))
    b[2] = 0.0
    w = RNG.normal(0, 0.5, (E, D, F))
    if nan:
        w[2, 37, 11] = np.nan
    (bj, bt), (wj, wt) = _pair(b, name), _pair(w, name)
    got = moe_gmm_plain(bt, wt)
    assert bool(got.isnan().any()) == nan
    if nan:
        assert bool(got[2, :, 11].isnan().all()) and int(got.isnan().sum()) == C
    else:
        assert not bool(got[2].any())
    tol = dict(rtol=5e-2, atol=5e-1) if name == "bfloat16" else dict(rtol=1e-3, atol=1e-3)
    for want in (moe_gmm_pallas(bj, wj, interpret=True), ref.moe_gmm_ref(bj, wj)):
        np.testing.assert_allclose(_np(got), _np(want), equal_nan=True, **tol)


@pytest.mark.parametrize("dtype,C,D,F,aligned,want", [
    (torch.float32, 320, 2048, 768, True, "fma"),
    (torch.float32, 8, 2048, 768, True, "fma"),
    (torch.bfloat16, 1, 2048, 768, True, "decode"),
    (torch.bfloat16, 16, 2048, 768, True, "decode"),
    (torch.bfloat16, 16, 100, 36, False, "wmma"),
    (torch.bfloat16, 17, 2048, 768, True, "tc_prefill"),
    (torch.bfloat16, 40, 2048, 768, True, "tc_prefill"),
    (torch.bfloat16, 320, 768, 2048, True, "tc_prefill"),
    (torch.bfloat16, 100, 200, 72, True, "tc_prefill"),
    (torch.bfloat16, 40, 100, 64, True, "wmma"),
    (torch.bfloat16, 40, 128, 36, True, "wmma"),
    (torch.bfloat16, 320, 2048, 768, False, "wmma"),
    # decode under TMA's rule: mixtral-8x22b's gate/up and down at one slot
    # and a round of 8, qwen3-moe's down, a D and F of no tile's width
    (torch.bfloat16, 1, 6144, 16384, True, "decode"),
    (torch.bfloat16, 8, 16384, 6144, True, "decode"),
    (torch.bfloat16, 8, 768, 2048, True, "decode"),
    (torch.bfloat16, 5, 200, 72, True, "decode"),
    # C <= 16 where the rule fails: a misaligned base, D or F no multiple of 8
    (torch.bfloat16, 1, 2048, 768, False, "wmma"),
    (torch.bfloat16, 8, 768, 2048, False, "wmma"),
    (torch.bfloat16, 8, 2044, 768, True, "wmma"),
    (torch.bfloat16, 1, 100, 64, True, "wmma"),
    (torch.bfloat16, 16, 128, 36, True, "wmma"),
])
def test_moe_gmm_variant_picker(dtype, C, D, F, aligned, want):
    """bf16 under TMA's rule (D and F multiples of 8, the bases 16-byte
    aligned) takes the decode kernel up to C = 16 tokens per expert and the
    TMA + wgmma prefill kernel above; bf16 that fails the rule takes the 64
    x 64 wmma tile at any C; f32 its FMA kernel."""
    assert moe_gmm._variant(dtype, C, D, F, aligned) == want
    assert want in moe_gmm.VARIANTS


# (C, D, F, dw, n_fast): qwen3-moe-30b-a3b's train microbatch (C = 320, d
# 2048, ff 768) and mixtral-8x22b's (C = 1280, d 6144, ff 16384), dX and dW
# of gate/up and down; the card tests' edges (C = 1, 40, 64, 65, 127, 128,
# 200, 321)
BWD_PLANS = [
    (320, 2048, 768, 0, 0), (320, 768, 2048, 0, 0),
    (320, 2048, 768, 1, 0), (320, 768, 2048, 1, 1),
    (1280, 6144, 16384, 0, 0), (1280, 16384, 6144, 0, 0),
    (1280, 6144, 16384, 1, 0), (1280, 16384, 6144, 1, 1),
    (1, 256, 64, 0, 0), (40, 256, 64, 0, 0), (64, 64, 256, 0, 0),
    (65, 256, 64, 0, 0), (127, 264, 256, 0, 0), (128, 256, 264, 0, 0),
    (200, 72, 72, 0, 0), (321, 512, 256, 0, 0), (40, 256, 64, 1, 0),
    (64, 64, 256, 1, 1),
]


@pytest.mark.parametrize("C,D,F,dw,n_fast", BWD_PLANS)
def test_moe_gmm_bwd_plan(C, D, F, dw, n_fast):
    """``_bwd_plan``: dX has one tile order (0); dW walks its F tiles
    fastest where F > D while both operands of an expert are under a
    quarter of L2 (qwen3-moe), else where bufᵀ outweighs dy (mixtral's
    down, whose bufᵀ is 42 MB an expert)."""
    assert moe_gmm._bwd_plan(C, D, F, dw) == n_fast


def test_moe_gmm_on_cpu_is_differentiable():
    """On the CPU ``ops.moe_gmm`` is the plain product, gradients included
    (dX = dY·Wᵀ, dW = Xᵀ·dY, through ``moe_gmm_bwd_plain``); on the card
    they come from the dX and dW kernels."""
    buf = torch.randn(3, 5, 16, dtype=torch.float64, requires_grad=True)
    w = torch.randn(3, 16, 8, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(ops.moe_gmm, (buf, w))
    assert ops.launch_counts() == NO_LAUNCHES
