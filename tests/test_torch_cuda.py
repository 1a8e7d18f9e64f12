"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Needs no JAX, so it runs on the GPU machine:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Elsewhere it skips (the kernels have no CPU mode). Tolerances are those of
tests/test_kernels.py (f32 2e-3, bf16 2e-2; for the grouped GEMM f32 1e-3,
bf16 5e-2 relative and 5e-1 absolute); lse is f32 statistics in both
versions, 2e-3. The SSD scan's final state is f32 in both versions, its y
in the input dtype; each is held to the input dtype's tolerance. The
grouped GEMM's and the SSD scan's backward kernels are held to 2e-3 (f32)
or 2e-2 (bf16), relative and of each output's largest value: they sum in
another order than the plain versions. The SSD backward's bf16 kernel is
also held to ``ssd_scan_bwd_tc_plain``, its own arithmetic, within two bf16
ulps (8e-3) relative and of each output's largest value: the two round the
same values to bf16, in another summation order, so a rounding may land
one ulp apart.
"""
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (
    HEAD_DIMS,
    _variant,
    flash_attention_bwd_cuda,
    flash_attention_bwd_plain,
    flash_attention_cuda,
    flash_attention_plain,
)
from repro_torch.kernels.moe_gmm import moe_gmm_cuda, moe_gmm_plain
from repro_torch.kernels.rmsnorm import rmsnorm_cuda, rmsnorm_plain
from repro_torch.kernels.ssd_scan import ssd_scan_cuda, ssd_scan_plain, ssd_scan_tc_plain

FLASH_CASES = [
    (128, 128, 4, 4, 64, True, 0),
    (128, 128, 8, 2, 64, True, 0),
    (256, 256, 4, 1, 32, True, 64),
    (64, 192, 4, 2, 64, False, 0),
    (96, 96, 2, 2, 128, True, 32),
    (1, 2048, 16, 16, 64, False, 0),    # decode against a 2048-slot cache
    (200, 200, 4, 4, 80, True, 0),      # zamba2's shared block: D = 80
    (1, 300, 4, 4, 80, False, 0),       # and its decode
    (150, 150, 4, 4, 96, True, 0),      # phi-3-vision: D = 96
    (1, 300, 8, 2, 96, False, 0),
    (300, 300, 4, 2, 256, True, 128),   # gemma3: GQA 2:1, D = 256, a local window
    (1, 300, 4, 2, 256, False, 0),      # and its decode
]
# the backward cases of tests/test_kernels.py, then every head dim with
# ragged S, windows and GQA up to 8:1 (gemma3's 2:1 at D = 256 with a window)
FLASH_BWD_CASES = [
    (128, 128, 4, 2, 32, True, 0),
    (128, 128, 4, 4, 64, True, 48),
    (64, 192, 4, 1, 32, False, 0),
    (100, 100, 8, 2, 128, True, 40),
    (77, 77, 8, 1, 32, True, 0),
    (300, 300, 16, 2, 64, True, 0),
    (200, 200, 4, 4, 80, True, 0),
    (129, 129, 8, 1, 80, False, 0),
    (150, 150, 8, 2, 96, True, 50),
    (70, 190, 4, 4, 96, False, 0),
    (257, 257, 8, 1, 128, True, 0),
    (300, 300, 4, 2, 256, True, 128),
    (65, 130, 8, 1, 256, False, 0),
    (3, 3, 4, 2, 128, True, 0),
    (1, 40, 2, 1, 80, False, 0),
]
# (E, C, D, F): the cases of tests/test_kernels.py, ragged C (1, 8 and 40
# tokens per expert: one slot, a decode round of 8, a 511-token admission
# of qwen3-moe), D and F that are no multiple of 8 (no 16-byte loads), and
# qwen3-moe's decode shape at 16 experts
GMM_CASES = [
    (2, 64, 128, 96), (8, 128, 64, 256), (3, 96, 160, 32),
    (4, 1, 256, 64), (4, 8, 256, 64), (4, 40, 256, 64),
    (3, 17, 100, 36), (2, 70, 33, 129),
    (16, 8, 2048, 768),
]
# (E, C, D, F) of the tensor-core prefill kernel (bf16, C > 16, D and F
# multiples of 8; 128 x 256 output tiles, 64-deep K steps): C below one
# 128-row tile (17, 40, 100), at it (128), one row past it (129), at
# qwen3-moe's 256 and 320 (gate/up and down widths; 320 leaves the last
# tile's second warpgroup without rows), and several tiles with a partial
# last one (500, 600, 700); F of one and two 256-column tiles, one tile
# and 8 columns (264), below one 64-column TMA box (40) and no multiple of
# it (72); D no multiple of the 64-deep step (136, 200)
GMM_TC_CASES = [
    (4, 17, 256, 256), (4, 40, 256, 512), (3, 100, 200, 72), (2, 128, 64, 256),
    (2, 129, 128, 264), (8, 256, 512, 256), (4, 320, 2048, 768), (4, 320, 768, 2048),
    (2, 64, 136, 40), (2, 500, 64, 256), (2, 600, 64, 256), (2, 700, 128, 264),
]
# (E, C, D, F) of the decode kernel (bf16, C <= 16, D and F multiples of 8;
# 128-column F tiles, 128-deep K steps): C = 1, 2, 8, 15, 16; F of two
# tiles, four, below one 64-column box (40), no multiple of it (72, 264); D
# below one step (64), no multiple of it (136, 200); qwen3-moe's widths; a
# long D (128 steps)
GMM_DECODE_CASES = [
    (4, 1, 256, 256), (4, 2, 128, 512), (3, 8, 200, 72), (2, 15, 136, 264),
    (2, 16, 64, 40), (16, 8, 2048, 768), (16, 1, 768, 2048), (2, 16, 16384, 512),
]
# (rows, d) of RMSNorm: each row mapping (a warp a row up to d = 2048 in
# bf16, 2 and 4 warps a row above, 8 for fewer rows than SMs, the wide
# kernel past 2048 vectors of 16 bytes), 4096 rows and 8, d no multiple of
# 8 (the scalar tail)
RMSNORM_ROWS = [(4096, 1024), (8, 1024), (4096, 2048), (8, 3840), (4096, 3840),
                (4096, 5120), (8, 5120), (3, 100), (4096, 1001), (8, 1001), (200, 5003),
                (5, 20003), (1, 8), (1000, 1)]
# (B, S, H, P, G, N): the SSD cases of tests/test_kernels.py, ragged S, and
# strided inputs at mamba2-370m's widths
SSD_CASES = [
    (1, 64, 2, 32, 1, 16), (2, 128, 4, 32, 2, 16), (1, 96, 4, 64, 1, 32),
    (2, 256, 8, 64, 2, 64), (2, 1, 4, 64, 1, 128), (1, 37, 4, 64, 2, 64),
    (2, 300, 4, 32, 1, 16), (1, 257, 32, 64, 1, 128),
]
# (B, S, H, P, G, N) of the bf16 SSD kernel: S at the edges of its 128-row
# chunk (1, 127, 128, 129, 257), G = 2 and 4 with several heads a group,
# every state dim, P = 32, 64, 128 (and 96: three 32-column tiles)
SSD_TC_CASES = [
    (2, 1, 4, 64, 1, 128), (1, 127, 8, 32, 2, 16), (1, 128, 8, 64, 2, 32),
    (2, 129, 16, 128, 4, 64), (1, 257, 8, 64, 4, 128), (2, 257, 16, 32, 4, 32),
    (1, 300, 8, 128, 2, 16), (2, 200, 8, 96, 2, 64),
]
# tests/test_kernels.py's tolerances for the grouped GEMM
GMM_TOL = {torch.float32: dict(rtol=1e-3, atol=1e-3),
           torch.bfloat16: dict(rtol=5e-2, atol=5e-1)}


def test_cuda_kernels_match_plain_versions_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    gen = torch.Generator("cuda").manual_seed(0)
    for dt, tol in ((torch.float32, 2e-3), (torch.bfloat16, 2e-2)):
        for shape in [(1, 7, 64), (4, 33, 128), (2, 256, 512), (8, 1024)]:
            x = torch.randn(shape, generator=gen, device="cuda").to(dt)
            s = torch.randn(shape[-1:], generator=gen, device="cuda").to(dt)
            torch.testing.assert_close(rmsnorm_cuda(x, s).float(),
                                       rmsnorm_plain(x, s).float(), rtol=tol, atol=tol)
        for S, T, Hq, Hkv, D, causal, window in FLASH_CASES:
            q = torch.randn(2, S, Hq, D, generator=gen, device="cuda").to(dt)
            k = torch.randn(2, T, Hkv, D, generator=gen, device="cuda").to(dt)
            v = torch.randn(2, T, Hkv, D, generator=gen, device="cuda").to(dt)
            kv_len = torch.tensor([T, max(1, T // 3)], dtype=torch.int32, device="cuda")
            for kl in (None, kv_len):
                o, lse = flash_attention_cuda(q, k, v, causal=causal, window=window,
                                              kv_len=kl)
                po, plse = flash_attention_plain(q, k, v, causal=causal,
                                                 window=window, kv_len=kl)
                torch.cuda.synchronize()
                torch.testing.assert_close(o.float(), po.float(), rtol=tol, atol=tol)
                torch.testing.assert_close(lse, plse, rtol=2e-3, atol=2e-3)


# The forward kernel's three variants: (B, S, T, Hq, Hkv, D, causal, window,
# kv_len or None). Ragged prefill at S = T in {1, 2, 5, 37, 300, 511};
# decode at S = 1 with GQA 1:1, 2:1 and 8:1 against T = 300 (no multiple of
# the 256-key chunk) with kv_len at 1, 63, 64, 65, 255, 256, 257 and T;
# S = 2..4 causal (admissions); a window in both regimes; every head dim
# (96 and 256 among them: phi-3-vision's and gemma3's).
DECODE_LENS = [1, 63, 64, 65, 255, 256, 257, 300]
FLASH_VARIANT_CASES = [
    (2, 1, 1, 4, 4, 64, True, 0, None),
    (2, 2, 2, 4, 2, 32, True, 0, None),
    (2, 5, 5, 4, 4, 80, True, 0, None),
    (2, 37, 37, 8, 2, 128, True, 0, None),
    (2, 300, 300, 4, 4, 64, True, 0, None),
    (2, 511, 511, 4, 1, 80, True, 0, None),
    (8, 1, 300, 4, 4, 64, False, 0, DECODE_LENS),
    (8, 1, 300, 8, 4, 32, False, 0, DECODE_LENS),
    (8, 1, 300, 32, 4, 128, False, 0, DECODE_LENS),
    (8, 1, 300, 4, 4, 80, False, 0, DECODE_LENS),
    (2, 2, 40, 4, 4, 64, True, 0, [40, 17]),
    (2, 3, 300, 8, 1, 128, True, 0, None),
    (2, 4, 100, 16, 2, 32, True, 0, [100, 3]),
    (2, 4, 300, 4, 4, 64, True, 2, [300, 150]),
    (2, 300, 300, 4, 2, 80, True, 64, None),
    (2, 200, 256, 4, 4, 32, False, 100, [256, 180]),
    (2, 37, 37, 4, 2, 96, True, 0, None),
    (2, 300, 300, 4, 2, 256, True, 128, None),
    (8, 1, 300, 8, 1, 96, False, 0, DECODE_LENS),
    (8, 1, 300, 4, 2, 256, False, 0, DECODE_LENS),
    (2, 4, 300, 4, 2, 256, True, 0, [300, 65]),
]


def _fused_qkv(B, S, Hq, Hkv, D, dt, gen):
    """q, k, v as views of one (B, S, (Hq + 2·Hkv)·D) projection."""
    qkv = torch.randn(B, S, (Hq + 2 * Hkv) * D, generator=gen, device="cuda").to(dt)
    q, k, v = torch.split(qkv, [Hq * D, Hkv * D, Hkv * D], dim=-1)
    return q.view(B, S, Hq, D), k.view(B, S, Hkv, D), v.view(B, S, Hkv, D)


def _check_flash(q, k, v, causal, window, kv_len, tol):
    o, lse = flash_attention_cuda(q, k, v, causal=causal, window=window, kv_len=kv_len)
    po, plse = flash_attention_plain(q, k, v, causal=causal, window=window, kv_len=kv_len)
    torch.cuda.synchronize()
    assert o.dtype == q.dtype and o.shape == po.shape and lse.shape == plse.shape
    torch.testing.assert_close(o.float(), po.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(lse, plse, rtol=2e-3, atol=2e-3)


def test_cuda_flash_forward_variants_match_plain_version_on_the_card():
    """Every case in f32 (the FMA kernel) and bf16 (tensor-core prefill or
    split-KV decode, by shape), then strided views as the model passes
    them: q/k/v split from one fused projection (prefill) and K/V as slices
    of a stacked (L, B, slots, Hkv, D) cache (decode and an admission).
    Each bf16 call takes the variant ``_variant`` names, never the FMA one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    gen = torch.Generator("cuda").manual_seed(5)
    ops.reset_launch_counts()
    want = dict.fromkeys(("tc_prefill", "split_decode", "fma"), 0)
    for dt, tol in ((torch.float32, 2e-3), (torch.bfloat16, 2e-2)):
        for B, S, T, Hq, Hkv, D, causal, window, lens in FLASH_VARIANT_CASES:
            q = torch.randn(B, S, Hq, D, generator=gen, device="cuda").to(dt)
            k, v = (torch.randn(B, T, Hkv, D, generator=gen, device="cuda").to(dt)
                    for _ in range(2))
            kv_len = None if lens is None else torch.tensor(lens, dtype=torch.int32,
                                                            device="cuda")
            _check_flash(q, k, v, causal, window, kv_len, tol)
            want[_variant(q, k)] += 1
        for B, S, Hq, Hkv, D in ((2, 300, 8, 2, 128), (2, 200, 32, 32, 80)):
            q, k, v = _fused_qkv(B, S, Hq, Hkv, D, dt, gen)
            _check_flash(q, k, v, True, 0, None, tol)
            want[_variant(q, k)] += 1
        for S, Hq, Hkv, D, causal in ((1, 32, 4, 128, False), (1, 16, 16, 64, False),
                                      (4, 8, 2, 64, True), (1, 32, 32, 80, False)):
            L, B, slots = 3, 4, 700
            q = torch.randn(B, S, Hq, D, generator=gen, device="cuda").to(dt)
            kv_len = torch.tensor([1, 256, 513, slots], dtype=torch.int32, device="cuda")
            # layer 1 of a stacked (L, B, slots, Hkv, D) cache, as decode_step
            # passes it (an offset view), then K and V of one fused
            # (B, slots, 2, Hkv, D) cache (strided views)
            stacked = torch.randn(2, L, B, slots, Hkv, D, generator=gen, device="cuda").to(dt)
            fused = torch.randn(B, slots, 2, Hkv, D, generator=gen, device="cuda").to(dt)
            for kc, vc in ((stacked[0, 1], stacked[1, 1]), (fused[:, :, 0], fused[:, :, 1])):
                assert kc.storage_offset() > 0 or not kc.is_contiguous()
                _check_flash(q, kc, vc, causal, 0, kv_len, tol)
                want[_variant(q, kc)] += 1
    torch.cuda.synchronize()
    assert ops.flash_variant_counts() == want
    assert want["fma"] == len(FLASH_VARIANT_CASES) + 10      # the f32 calls only
    assert ops.launch_counts()["flash_fwd"] == sum(want.values())


def test_cuda_flash_forward_refuses_misaligned_bf16_views():
    """TMA and cp.async need 16-byte aligned bases and strides: a view that
    is not raises (naming the tensor) and launches nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    bf16 = torch.bfloat16
    q = torch.randn(2, 64, 4, 64, device="cuda", dtype=bf16)
    k = torch.randn(2, 64, 4, 64, device="cuda", dtype=bf16)
    shifted = torch.randn(2 * 64 * 4 * 64 + 1, device="cuda", dtype=bf16)[1:].view(2, 64, 4, 64)
    padded = torch.randn(2, 64, 4, 65, device="cuda", dtype=bf16)[..., :64]
    ops.reset_launch_counts()
    for args, name in (((shifted, k, k), "q"), ((q, padded, k), "k"),
                       ((q, k, shifted), "v"), ((q[:, :1], padded, k), "k")):
        with pytest.raises(ValueError, match=f"{name} .*16-byte aligned"):
            flash_attention_cuda(*args, causal=True, window=0)
    assert ops.launch_counts()["flash_fwd"] == 0
    # f32 takes the FMA kernel, which has no such need
    o, _ = flash_attention_cuda(padded.float(), padded.float(), padded.float(),
                                causal=True, window=0)
    torch.cuda.synchronize()
    assert ops.flash_variant_counts() == {"tc_prefill": 0, "split_decode": 0, "fma": 1}


def test_cuda_wrapper_rejects_a_host_kv_len_below_one():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    q = torch.zeros(2, 1, 2, 32, device="cuda")
    k = torch.zeros(2, 8, 2, 32, device="cuda")
    with pytest.raises(ValueError, match="at least one valid key"):
        flash_attention_cuda(q, k, k, causal=False, window=0,
                             kv_len=torch.tensor([3, 0], dtype=torch.int32))


def test_cuda_wrappers_count_their_launches():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    ops.reset_launch_counts()
    x = torch.randn(8, 1024, device="cuda", dtype=torch.bfloat16)
    ops.rmsnorm(x, torch.ones(1024, device="cuda", dtype=torch.bfloat16))
    q = torch.randn(2, 1, 4, 64, device="cuda", dtype=torch.bfloat16)
    k = torch.randn(2, 16, 4, 64, device="cuda", dtype=torch.bfloat16)
    ops.flash_attention_fwd(q, k, k, causal=False, window=0,
                            kv_len=torch.tensor([3, 16], dtype=torch.int32))
    torch.cuda.synchronize()
    assert ops.launch_counts() == {"rmsnorm": 1, "flash_fwd": 1, "flash_bwd_dq": 0,
                                   "flash_bwd_dkv": 0, "moe_gmm": 0, "moe_gmm_dx": 0,
                                   "moe_gmm_dw": 0, "ssd_scan": 0, "ssd_scan_bwd": 0}
    # one differentiable call and its backward: one launch of each flash kernel
    ops.reset_launch_counts()
    q = torch.randn(2, 32, 4, 64, device="cuda", dtype=torch.bfloat16, requires_grad=True)
    o = ops.flash_attention(q, k, k, causal=True, window=0)
    torch.autograd.grad(o.float().square().sum(), q)
    torch.cuda.synchronize()
    assert ops.launch_counts() == {"rmsnorm": 0, "flash_fwd": 1, "flash_bwd_dq": 1,
                                   "flash_bwd_dkv": 1, "moe_gmm": 0, "moe_gmm_dx": 0,
                                   "moe_gmm_dw": 0, "ssd_scan": 0, "ssd_scan_bwd": 0}


def test_cuda_backward_kernels_match_plain_version_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    gen = torch.Generator("cuda").manual_seed(1)
    for dt, tol in ((torch.float32, 2e-3), (torch.bfloat16, 2e-2)):
        for S, T, Hq, Hkv, D, causal, window in FLASH_BWD_CASES:
            q, do = (torch.randn(2, S, Hq, D, generator=gen, device="cuda").to(dt)
                     for _ in range(2))
            k, v = (torch.randn(2, T, Hkv, D, generator=gen, device="cuda").to(dt)
                    for _ in range(2))
            o, lse = flash_attention_cuda(q, k, v, causal=causal, window=window)
            got = flash_attention_bwd_cuda(q, k, v, o, lse, do, causal=causal,
                                           window=window)
            want = flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                             window=window)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                assert g.dtype == w.dtype and g.shape == w.shape
                torch.testing.assert_close(g.float(), w.float(), rtol=tol, atol=tol)


def test_cuda_backward_launches_by_variant():
    """bf16 takes the tensor-core kernels, f32 the FMA ones, at every head
    dim; each call launches one dq and one dk/dv kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    gen = torch.Generator("cuda").manual_seed(6)
    ops.reset_launch_counts()
    for dt in (torch.float32, torch.bfloat16):
        for D in HEAD_DIMS:
            q, k, v, do = (torch.randn(1, 70, 2, D, generator=gen, device="cuda").to(dt)
                           for _ in range(4))
            o, lse = flash_attention_cuda(q, k, v, causal=True, window=0)
            flash_attention_bwd_cuda(q, k, v, o, lse, do, causal=True, window=0)
    torch.cuda.synchronize()
    n = len(HEAD_DIMS)
    assert ops.flash_bwd_variant_counts() == {"flash_bwd_dq": {"tc": n, "fma": n},
                                              "flash_bwd_dkv": {"tc": n, "fma": n}}
    counts = ops.launch_counts()
    assert counts["flash_bwd_dq"] == counts["flash_bwd_dkv"] == 2 * n


def test_cuda_backward_wrapper_refuses_kv_len():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    q = torch.randn(1, 8, 2, 32, device="cuda")
    o, lse = flash_attention_cuda(q, q, q, causal=True, window=0)
    with pytest.raises(ValueError, match="kv_len"):
        flash_attention_bwd_cuda(q, q, q, o, lse, o, causal=True, window=0,
                                 kv_len=torch.tensor([8], dtype=torch.int32))


def test_cuda_moe_gmm_matches_plain_version_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    gen = torch.Generator("cuda").manual_seed(2)
    for dt in (torch.float32, torch.bfloat16):
        for E, C, D, F in GMM_CASES:
            buf = torch.randn(E, C, D, generator=gen, device="cuda").to(dt)
            w = (0.5 * torch.randn(E, D, F, generator=gen, device="cuda")).to(dt)
            got = moe_gmm_cuda(buf, w)
            want = moe_gmm_plain(buf, w)
            torch.cuda.synchronize()
            assert got.dtype == dt and got.shape == (E, C, F)
            torch.testing.assert_close(got.float(), want.float(), **GMM_TOL[dt])


def test_cuda_moe_gmm_tc_prefill_matches_plain_version_at_ragged_c():
    """The TMA + wgmma kernel at ragged C, D and F; every launch counted on
    its variant."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    gen = torch.Generator("cuda").manual_seed(3)
    ops.reset_launch_counts()
    for E, C, D, F in GMM_TC_CASES:
        buf = torch.randn(E, C, D, generator=gen, device="cuda").to(torch.bfloat16)
        w = (D ** -0.5 * torch.randn(E, D, F, generator=gen, device="cuda")).to(torch.bfloat16)
        got = moe_gmm_cuda(buf, w)
        want = moe_gmm_plain(buf, w)
        torch.cuda.synchronize()
        assert got.shape == (E, C, F)
        torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-2)
    assert ops.moe_gmm_variant_counts() == {"tc_prefill": len(GMM_TC_CASES), "decode": 0,
                                            "wmma": 0, "fma": 0}


def test_cuda_moe_gmm_decode_matches_plain_version_and_repeats_bit_for_bit():
    """The decode kernel at C = 1..16, ragged D and F, and more tiles than
    blocks (a block walks several); an expert of all-zero rows with a NaN in
    its w gives NaN where the plain version does; a second call on the same
    inputs is equal bit for bit; every launch on ``decode``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    gen = torch.Generator("cuda").manual_seed(6)
    ops.reset_launch_counts()
    for E, C, D, F in GMM_DECODE_CASES:
        buf = torch.randn(E, C, D, generator=gen, device="cuda").to(torch.bfloat16)
        w = (D ** -0.5 * torch.randn(E, D, F, generator=gen, device="cuda")).to(torch.bfloat16)
        got, again = moe_gmm_cuda(buf, w), moe_gmm_cuda(buf, w)
        want = moe_gmm_plain(buf, w)
        torch.cuda.synchronize()
        assert got.shape == (E, C, F) and torch.equal(got, again)
        torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-2)
        buf[1] = 0
        w[1, D // 2, F // 3] = float("nan")
        got, want = moe_gmm_cuda(buf, w), moe_gmm_plain(buf, w)
        torch.cuda.synchronize()
        assert int(want.isnan().sum()) == C
        torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-2,
                                   equal_nan=True)
    assert ops.moe_gmm_variant_counts() == {"tc_prefill": 0, "decode": 3 * len(GMM_DECODE_CASES),
                                            "wmma": 0, "fma": 0}


def test_cuda_moe_gmm_takes_the_wmma_tile_where_tma_cannot_read():
    """A base 2 bytes past a 16-byte boundary, or a D or F no multiple of 8:
    the 64 x 64 wmma tile at any C, by the picker's rule; the decode kernel
    at C <= 16 where the rule holds."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    gen = torch.Generator("cuda").manual_seed(4)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    flat = randn(1 + 2 * 40 * 64)
    cases = [(flat[1:].view(2, 40, 64), randn(2, 64, 32)),
             (randn(2, 40, 60), randn(2, 60, 32)), (randn(2, 16, 64), randn(2, 64, 32)),
             (flat[1:1 + 2 * 8 * 64].view(2, 8, 64), randn(2, 64, 32)),
             (randn(2, 1, 60), randn(2, 60, 32)), (randn(2, 16, 64), randn(2, 64, 36))]
    ops.reset_launch_counts()
    for buf, w in cases:
        assert buf.is_contiguous()
        torch.testing.assert_close(moe_gmm_cuda(buf, w).float(),
                                   moe_gmm_plain(buf, w).float(), rtol=2e-2, atol=2e-2)
    assert ops.moe_gmm_variant_counts() == {"tc_prefill": 0, "decode": 1, "wmma": 5,
                                            "fma": 0}


def test_cuda_rmsnorm_row_mappings_match_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    gen = torch.Generator("cuda").manual_seed(5)
    for dt, tol in ((torch.float32, 2e-3), (torch.bfloat16, 2e-2)):
        for rows, d in RMSNORM_ROWS:
            x = torch.randn(rows, d, generator=gen, device="cuda").to(dt)
            s = (1 + 0.1 * torch.randn(d, generator=gen, device="cuda")).to(dt)
            torch.testing.assert_close(rmsnorm_cuda(x, s).float(),
                                       rmsnorm_plain(x, s).float(), rtol=tol, atol=tol)
        # a base 4 (f32) or 2 (bf16) bytes past a 16-byte boundary: element loads
        flat = torch.randn(1 + 33 * 1024, generator=gen, device="cuda").to(dt)
        x, s = flat[1:].view(33, 1024), flat[1:1025]
        torch.testing.assert_close(rmsnorm_cuda(x, s).float(), rmsnorm_plain(x, s).float(),
                                   rtol=tol, atol=tol)


def test_cuda_moe_gmm_wrapper_refuses_bad_inputs_and_counts_launches():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    buf = torch.randn(2, 8, 64, device="cuda", dtype=torch.bfloat16)
    w = torch.randn(2, 64, 32, device="cuda", dtype=torch.bfloat16)
    bad = [((buf, w[:, :32]), "want buf"), ((buf, w[:1]), "want buf"),
           ((buf, w.float()), "dtypes"), ((buf.half(), w.half()), "dtypes"),
           ((buf.transpose(1, 2).contiguous().transpose(1, 2), w), "contiguous"),
           ((buf, w.cpu()), "one CUDA device")]
    for args, match in bad:
        with pytest.raises(ValueError, match=match):
            moe_gmm_cuda(*args)
    ops.reset_launch_counts()
    for _ in range(3):
        ops.moe_gmm(buf, w)
    torch.cuda.synchronize()
    assert ops.launch_counts()["moe_gmm"] == 3
    empty = moe_gmm_cuda(buf[:, :0], w)
    assert empty.shape == (2, 0, 32) and ops.launch_counts()["moe_gmm"] == 3


# (E, C, D, F) of the backward: C = 1, 8, 17, 40, 320 tokens per expert
# (the contraction of dW; 320 is qwen3-moe's train microbatch), D and F of
# one tile and partial ones, then D or F no multiple of 8 (the wmma tile),
# then the tc kernel's edges: one 64-deep K step with N one tile (dX at C
# = 40 and 64, dW at C = 64), C = 64, 65, 127, 128 and 320 around dW's
# 64-deep steps and within dX's 320-token tile, D and F of 64, 256 and 264
GMM_BWD_CASES = [(4, 1, 256, 64), (4, 8, 256, 64), (3, 17, 136, 264), (4, 40, 200, 72),
                 (2, 320, 512, 256), (3, 17, 100, 36), (2, 70, 33, 129),
                 (4, 40, 256, 64), (2, 64, 256, 64), (2, 64, 64, 256), (2, 65, 64, 256),
                 (2, 127, 264, 256), (2, 128, 256, 264), (2, 320, 64, 264), (3, 320, 264, 64)]


def _gmm_bwd_tol(dt, want):
    """2e-2 (bf16) or 2e-3 (f32) relative, and of the largest value: a
    product that sums C or F terms in another order."""
    tol = 2e-2 if dt == torch.bfloat16 else 2e-3
    return dict(rtol=tol, atol=tol * float(want.float().abs().max()))


def test_cuda_moe_gmm_backward_kernels_match_plain_version():
    """dX = dy·wᵀ and dW = bufᵀ·dy against ``moe_gmm_bwd_plain``, f32 and
    bf16, at ragged C and D/F of no tile's width; each launch on the
    variant ``_bwd_variant`` names (bf16 with D, F multiples of 8 on ``tc``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from repro_torch.kernels.moe_gmm import _bwd_variant, moe_gmm_bwd_plain, moe_gmm_dw_cuda, \
        moe_gmm_dx_cuda
    gen = torch.Generator("cuda").manual_seed(8)
    ops.reset_launch_counts()
    want = {"tc": 0, "wmma": 0, "fma": 0}
    for (E, C, D, F) in GMM_BWD_CASES:
        for dt in (torch.float32, torch.bfloat16):
            buf = torch.randn(E, C, D, generator=gen, device="cuda").to(dt)
            w = (D ** -0.5 * torch.randn(E, D, F, generator=gen, device="cuda")).to(dt)
            dy = torch.randn(E, C, F, generator=gen, device="cuda").to(dt)
            dbuf, dw = moe_gmm_dx_cuda(dy, w), moe_gmm_dw_cuda(buf, dy)
            pbuf, pw = moe_gmm_bwd_plain(buf, w, dy)
            torch.cuda.synchronize()
            assert dbuf.dtype == dw.dtype == dt
            torch.testing.assert_close(dbuf.float(), pbuf.float(), **_gmm_bwd_tol(dt, pbuf))
            torch.testing.assert_close(dw.float(), pw.float(), **_gmm_bwd_tol(dt, pw))
            want[_bwd_variant(dt, D, F, True)] += 1
    assert ops.moe_gmm_bwd_variant_counts() == {"moe_gmm_dx": want, "moe_gmm_dw": want}
    assert want["tc"] == 13 and want["wmma"] == 2


def test_cuda_moe_gmm_backward_tc_is_bit_identical_call_to_call():
    """Every bf16 case on ``tc``: dX and dW twice each, equal bit for bit
    (each output summed in one block in a fixed order, no atomics)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from repro_torch.kernels.moe_gmm import _bwd_variant, moe_gmm_dw_cuda, moe_gmm_dx_cuda
    gen = torch.Generator("cuda").manual_seed(10)
    for (E, C, D, F) in GMM_BWD_CASES:
        if _bwd_variant(torch.bfloat16, D, F, True) != "tc":
            continue
        buf = torch.randn(E, C, D, generator=gen, device="cuda").bfloat16()
        w = (D ** -0.5 * torch.randn(E, D, F, generator=gen, device="cuda")).bfloat16()
        dy = torch.randn(E, C, F, generator=gen, device="cuda").bfloat16()
        assert torch.equal(moe_gmm_dx_cuda(dy, w), moe_gmm_dx_cuda(dy, w)), (E, C, D, F)
        assert torch.equal(moe_gmm_dw_cuda(buf, dy), moe_gmm_dw_cuda(buf, dy)), (E, C, D, F)


def test_cuda_moe_gmm_gradients_come_from_the_backward_kernels(monkeypatch):
    """With grad on, ``ops.moe_gmm`` goes through the Function: one forward
    launch, then one dX and one dW launch, never the plain backward, and
    the gradients match it; under no_grad only the forward launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from repro_torch.kernels.moe_gmm import moe_gmm_bwd_plain
    gen = torch.Generator("cuda").manual_seed(9)
    buf = torch.randn(4, 40, 256, generator=gen, device="cuda").bfloat16()
    w = (torch.randn(4, 256, 64, generator=gen, device="cuda") / 16).bfloat16()
    dy = torch.randn(4, 40, 64, generator=gen, device="cuda").bfloat16()
    want = moe_gmm_bwd_plain(buf, w, dy)

    def refuse(*args):
        raise AssertionError("the plain backward ran on the card")

    monkeypatch.setattr(ops, "moe_gmm_bwd_plain", refuse)
    ops.reset_launch_counts()
    b, ww = buf.clone().requires_grad_(), w.clone().requires_grad_()
    got = torch.autograd.grad(ops.moe_gmm(b, ww), (b, ww), dy)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert (counts["moe_gmm"], counts["moe_gmm_dx"], counts["moe_gmm_dw"]) == (1, 1, 1)
    assert ops.moe_gmm_bwd_variant_counts()["moe_gmm_dw"]["tc"] == 1
    for g, p in zip(got, want):
        torch.testing.assert_close(g.float(), p.float(), **_gmm_bwd_tol(torch.bfloat16, p))
    with torch.no_grad():
        ops.moe_gmm(b, ww)
    counts = ops.launch_counts()
    assert (counts["moe_gmm"], counts["moe_gmm_dx"], counts["moe_gmm_dw"]) == (2, 1, 1)


def _ssd_inputs(B, S, H, P, G, N, dt, gen, strided=False, a_range=(0.5, 2.0)):
    """tests/test_kernels.py's distributions in dtype ``dt`` (a ~ -U[a_range]);
    ``strided``: xh, B_ and C_ as views into one (B, S, H·P + 2·G·N) tensor,
    as the model passes them."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    if strided:
        xbc = randn(B, S, H * P + 2 * G * N)
        xbc[..., H * P:] *= 0.5
        xs, b, c = torch.split(xbc.to(dt), [H * P, G * N, G * N], dim=-1)
        xh, b, c = xs.reshape(B, S, H, P), b.reshape(B, S, G, N), c.reshape(B, S, G, N)
    else:
        xh, b, c = (t.to(dt) for t in (randn(B, S, H, P), 0.5 * randn(B, S, G, N),
                                       0.5 * randn(B, S, G, N)))
    d = 1e-3 + 0.099 * torch.rand(B, S, H, generator=gen, device="cuda")
    lo, hi = a_range
    a = -(lo + (hi - lo) * torch.rand(H, generator=gen, device="cuda"))
    return [xh, d.to(dt), a.to(dt), b, c]


def test_cuda_ssd_scan_matches_plain_version_on_the_card():
    """y and the final state, f32 and bf16, contiguous and strided inputs
    (the strided ones keep their views: the kernel reads the strides). The
    final state is held to f32's tolerance whatever the inputs' type: both
    versions compute it in f32 from the same inputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    gen = torch.Generator("cuda").manual_seed(3)
    for dt, tol in ((torch.float32, 2e-3), (torch.bfloat16, 2e-2)):
        for case in SSD_CASES:
            for strided in (False, True):
                ins = _ssd_inputs(*case, dt, gen, strided)
                if strided:
                    assert not any(t.is_contiguous() for t in (ins[0], ins[3], ins[4]))
                y, h = ssd_scan_cuda(*ins)
                py, ph = ssd_scan_plain(*ins)
                torch.cuda.synchronize()
                assert y.dtype == dt and h.dtype == torch.float32
                torch.testing.assert_close(y.float(), py.float(), rtol=tol, atol=tol)
                torch.testing.assert_close(h, ph, rtol=2e-3, atol=2e-3)


def test_cuda_ssd_scan_refuses_bad_inputs_and_differentiates_through_its_kernels(monkeypatch):
    """Unsupported state dims, head dims, mixed dtypes and a non-contiguous
    last dim are refused. With grad on, ``ops.ssd_scan`` goes through the
    Function: one forward launch, one backward launch, never the plain
    backward, gradients as ``ssd_scan_bwd_plain``'s; an unused final state
    reaches the backward as no gradient; under no_grad only the forward
    launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from repro_torch.kernels.ssd_scan import ssd_scan_bwd_plain
    gen = torch.Generator("cuda").manual_seed(4)
    xh, dt, a, b, c = _ssd_inputs(1, 16, 2, 32, 1, 16, torch.float32, gen)
    bad = [((xh, dt, a, b[..., :8], c[..., :8]), "state dim"),
           ((xh[..., :16], dt, a, b, c), "head dim"),
           ((xh, dt.bfloat16(), a, b, c), "dtypes"),
           ((xh.transpose(1, 3).contiguous().transpose(1, 3), dt, a, b, c), "contiguous"),
           ((xh, dt, a.cpu(), b, c), "one CUDA device")]
    for args, match in bad:
        with pytest.raises(ValueError, match=match):
            ssd_scan_cuda(*args)
    ins = _ssd_inputs(2, 100, 4, 32, 2, 16, torch.float32, gen, strided=True)
    dy = torch.randn(2, 100, 4, 32, generator=gen, device="cuda")
    want = ssd_scan_bwd_plain(*ins, dy)

    def refuse(*args):
        raise AssertionError("the plain backward ran on the card")

    monkeypatch.setattr(ops, "ssd_scan_bwd_plain", refuse)
    ops.reset_launch_counts()
    leaves = [t.detach().clone().requires_grad_() for t in ins]
    y, _ = ops.ssd_scan(*leaves)
    got = torch.autograd.grad(y, leaves, dy)
    torch.cuda.synchronize()
    assert ops.launch_counts()["ssd_scan"] == 1 and ops.launch_counts()["ssd_scan_bwd"] == 1
    assert ops.ssd_scan_bwd_variant_counts() == {"tc": 0, "fma": 1}
    for g, p in zip(got, want):
        torch.testing.assert_close(g, p, rtol=2e-3, atol=2e-3 * float(p.abs().max()))
    with torch.no_grad():
        y, h = ops.ssd_scan(*ins)
    py, ph = ssd_scan_plain(*ins)
    torch.testing.assert_close(y, py, rtol=2e-3, atol=2e-3)
    torch.testing.assert_close(h, ph, rtol=2e-3, atol=2e-3)
    assert ops.launch_counts()["ssd_scan"] == 2 and ops.launch_counts()["ssd_scan_bwd"] == 1


# (B, S, H, P, G, N) of the SSD backward: S at the 64-row tile's edges and
# ragged (1, 37, 63, 64, 65, 127, 129, 300), G = 1, 2, 4 with several
# heads a group, every state dim, P = 32, 64, 128
SSD_BWD_CASES = [
    (2, 1, 4, 64, 1, 128), (1, 37, 8, 32, 2, 16), (2, 63, 4, 64, 1, 32),
    (1, 64, 8, 128, 4, 64), (2, 65, 8, 32, 2, 128), (1, 127, 4, 64, 2, 16),
    (2, 129, 16, 64, 4, 32), (1, 300, 8, 128, 1, 64),
]


def test_cuda_ssd_scan_backward_matches_plain_version():
    """dxh, ddt, da, dB and dC against ``ssd_scan_bwd_plain``, f32 within
    2e-3 and bf16 within 2e-2, relative and of each output's largest value
    (dB, dC, ddt and da are sums in no fixed order: f32 atomics over the
    heads of a group, the P tiles, batch and sequence), strided model
    views, strong decay, dh_final zero and not. The largest value is taken
    as at least 1e-3: at S = 1 da is exactly 0 (a single row's decay
    leaves no trace) and the kernel's cancelling f32 sums leave ~1e-9."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from repro_torch.kernels.ssd_scan import ssd_scan_bwd_cuda, ssd_scan_bwd_plain
    gen = torch.Generator("cuda").manual_seed(10)
    ops.reset_launch_counts()
    n = {"tc": 0, "fma": 0}
    for i, (B, S, H, P, G, N) in enumerate(SSD_BWD_CASES):
        for dt, tol in ((torch.float32, 2e-3), (torch.bfloat16, 2e-2)):
            ins = _ssd_inputs(B, S, H, P, G, N, dt, gen, strided=True,
                              a_range=(1.0, 16.0) if i % 2 else (0.5, 2.0))
            dy = torch.randn(B, S, H, P, generator=gen, device="cuda").to(dt)
            dh = torch.randn(B, H, P, N, generator=gen, device="cuda") if i % 3 else None
            got = ssd_scan_bwd_cuda(*ins, dy, dh)
            want = ssd_scan_bwd_plain(*ins, dy, dh)
            torch.cuda.synchronize()
            for name, g, p in zip(("dxh", "ddt", "da", "dB", "dC"), got, want):
                assert g.dtype == p.dtype, name
                scale = max(float(p.float().abs().max()), 1e-3)
                torch.testing.assert_close(g.float(), p.float(), rtol=tol, atol=tol * scale,
                                           msg=lambda m: f"{name} {(B, S, H, P, G, N)} {dt}: {m}")
            n["tc" if dt == torch.bfloat16 else "fma"] += 1
    assert ops.ssd_scan_bwd_variant_counts() == n


# (B, S, H, P, G, N) of the bf16 backward: S at its 128-row chunk's edges
# (1, 127, 128, 129, 257, 300), G = 1, 2, 4 with up to 8 heads a group
# (several heads a block), every state dim, P = 32, 64, 128 (two P tiles)
SSD_BWD_TC_CASES = [
    (2, 1, 4, 64, 1, 128), (1, 127, 8, 32, 2, 16), (2, 128, 8, 64, 1, 32),
    (1, 129, 16, 128, 2, 64), (2, 257, 8, 64, 4, 128), (1, 300, 16, 32, 4, 64),
    (2, 300, 8, 128, 1, 16), (1, 1024, 4, 64, 1, 128),
]


def test_cuda_ssd_scan_backward_tc_matches_its_arithmetic_and_the_plain_version():
    """The bf16 kernel (three launches: the chunk states, the chains over
    the chunks, the chunks' gradients) at its chunk's edges, strided model
    views, both a ranges, dh_final zero and not: within two bf16 ulps of
    ``ssd_scan_bwd_tc_plain`` and within 2e-2 of ``ssd_scan_bwd_plain``,
    relative and of each output's largest value (at least 1e-3: at S = 1
    da is 0); every call on ``tc``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from repro_torch.kernels.ssd_scan import (
        ssd_scan_bwd_cuda, ssd_scan_bwd_plain, ssd_scan_bwd_tc_plain)
    gen = torch.Generator("cuda").manual_seed(11)
    ops.reset_launch_counts()
    for i, (B, S, H, P, G, N) in enumerate(SSD_BWD_TC_CASES):
        ins = _ssd_inputs(B, S, H, P, G, N, torch.bfloat16, gen, strided=True,
                          a_range=(1.0, 16.0) if i % 2 else (0.5, 2.0))
        dy = torch.randn(B, S, H, P, generator=gen, device="cuda").bfloat16()
        dh = torch.randn(B, H, P, N, generator=gen, device="cuda") if i % 3 else None
        got = ssd_scan_bwd_cuda(*ins, dy, dh)
        for want, tol in ((ssd_scan_bwd_tc_plain(*ins, dy, dh), 8e-3),
                          (ssd_scan_bwd_plain(*ins, dy, dh), 2e-2)):
            torch.cuda.synchronize()
            for name, g, p in zip(("dxh", "ddt", "da", "dB", "dC"), got, want):
                assert g.dtype == p.dtype == torch.bfloat16, name
                scale = max(float(p.float().abs().max()), 1e-3)
                torch.testing.assert_close(
                    g.float(), p.float(), rtol=tol, atol=tol * scale,
                    msg=lambda m: f"{name} {(B, S, H, P, G, N)} tol {tol}: {m}")
    assert ops.ssd_scan_bwd_variant_counts() == {"tc": len(SSD_BWD_TC_CASES), "fma": 0}


def test_cuda_ssd_scan_backward_tc_refuses_misaligned_views():
    """The bf16 backward reads xh, B_, C_ and dy through TMA: a base that is
    not a multiple of 16 bytes raises, naming the tensor, and launches
    nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from repro_torch.kernels.ssd_scan import ssd_scan_bwd_cuda
    gen = torch.Generator("cuda").manual_seed(12)
    ins = _ssd_inputs(2, 64, 4, 64, 1, 64, torch.bfloat16, gen, strided=True)
    dy = torch.randn(2, 64, 4, 64, generator=gen, device="cuda").bfloat16()

    def shifted(t):
        return torch.randn(t.numel() + 1, device="cuda").to(t.dtype)[1:].view(t.shape)

    ops.reset_launch_counts()
    xh, dt, a, b, c = ins
    for args, name in (((shifted(xh), dt, a, b, c, dy), "xh"),
                       ((xh, dt, a, shifted(b), c, dy), "B_"),
                       ((xh, dt, a, b, shifted(c), dy), "C_"),
                       ((xh, dt, a, b, c, shifted(dy)), "dy")):
        with pytest.raises(ValueError, match=f"{name} .*16-byte aligned"):
            ssd_scan_bwd_cuda(*args)
    assert ops.launch_counts()["ssd_scan_bwd"] == 0


def test_cuda_ssd_scan_tc_matches_plain_versions_on_the_card():
    """The bf16 kernel at its chunk's edges, with groups of several heads,
    every state dim and P = 32 .. 128, strided model views and strong decay
    (a down to -16): y within 2e-2 and the final state within 2e-3 (abs and
    rel) of ``ssd_scan_plain`` and of ``ssd_scan_tc_plain`` (its own
    arithmetic); every launch on ``tc``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    gen = torch.Generator("cuda").manual_seed(5)
    ops.reset_launch_counts()
    n = 0
    for case in SSD_TC_CASES:
        for a_range in ((0.5, 2.0), (1.0, 16.0)):
            ins = _ssd_inputs(*case, torch.bfloat16, gen, strided=True, a_range=a_range)
            y, h = ssd_scan_cuda(*ins)
            n += 1
            for py, ph in (ssd_scan_plain(*ins), ssd_scan_tc_plain(*ins)):
                torch.cuda.synchronize()
                torch.testing.assert_close(y.float(), py.float(), rtol=2e-2, atol=2e-2)
                torch.testing.assert_close(h, ph, rtol=2e-3, atol=2e-3)
    assert ops.ssd_scan_variant_counts() == {"tc": n, "fma": 0}
    # f32 takes the FMA kernel
    ins = _ssd_inputs(*SSD_TC_CASES[1], torch.float32, gen, strided=True)
    y, h = ssd_scan_cuda(*ins)
    py, ph = ssd_scan_plain(*ins)
    torch.testing.assert_close(y, py, rtol=2e-3, atol=2e-3)
    torch.testing.assert_close(h, ph, rtol=2e-3, atol=2e-3)
    assert ops.ssd_scan_variant_counts() == {"tc": n, "fma": 1}
    # launch after launch on one stream: the kernel leaves its flags at 0
    ins = _ssd_inputs(2, 300, 8, 64, 1, 128, torch.bfloat16, gen, strided=True)
    first = ssd_scan_cuda(*ins)
    for _ in range(5):
        again = ssd_scan_cuda(*ins)
    torch.cuda.synchronize()
    assert all(torch.equal(u, v) for u, v in zip(first, again))


def test_cuda_ssd_scan_refuses_misaligned_bf16_views():
    """The bf16 kernel reads xh, B_ and C_ through TMA: a base or a stride
    that is not a multiple of 16 bytes raises, naming the tensor, and
    launches nothing; f32 takes the FMA kernel, which has no such need."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    gen = torch.Generator("cuda").manual_seed(6)
    xh, dt, a, b, c = _ssd_inputs(2, 64, 4, 64, 1, 64, torch.bfloat16, gen, strided=True)

    def shifted(t):
        return torch.randn(t.numel() + 1, device="cuda").to(t.dtype)[1:].view(t.shape)

    odd = torch.randn(2, 64, 4 * 64 + 2 * 64 + 1, device="cuda").bfloat16()
    xo, bo, co = torch.split(odd[..., :-1], [256, 64, 64], dim=-1)   # row stride 385
    ops.reset_launch_counts()
    for args, name in (((shifted(xh), dt, a, b, c), "xh"),
                       ((xh, dt, a, shifted(b), c), "B_"),
                       ((xh, dt, a, b, shifted(c)), "C_"),
                       ((xo.reshape(2, 64, 4, 64), dt, a, bo.reshape(2, 64, 1, 64),
                         co.reshape(2, 64, 1, 64)), "xh")):
        with pytest.raises(ValueError, match=f"{name} .*16-byte aligned"):
            ssd_scan_cuda(*args)
    assert ops.launch_counts()["ssd_scan"] == 0
    y, h = ssd_scan_cuda(*(t.float() for t in (xo.reshape(2, 64, 4, 64), dt, a,
                                               bo.reshape(2, 64, 1, 64),
                                               co.reshape(2, 64, 1, 64))))
    torch.cuda.synchronize()
    assert ops.ssd_scan_variant_counts() == {"tc": 0, "fma": 1}
