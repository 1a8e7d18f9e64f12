"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Needs no JAX, so it runs on the GPU machine:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Elsewhere it skips (the kernels have no CPU mode). Tolerances are those of
tests/test_kernels.py (f32 2e-3, bf16 2e-2); lse is f32 statistics in both
versions, 2e-3.
"""
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (
    flash_attention_cuda,
    flash_attention_plain,
)
from repro_torch.kernels.rmsnorm import rmsnorm_cuda, rmsnorm_plain

FLASH_CASES = [
    (128, 128, 4, 4, 64, True, 0),
    (128, 128, 8, 2, 64, True, 0),
    (256, 256, 4, 1, 32, True, 64),
    (64, 192, 4, 2, 64, False, 0),
    (96, 96, 2, 2, 128, True, 32),
    (1, 2048, 16, 16, 64, False, 0),    # decode against a 2048-slot cache
]


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
    assert ops.launch_counts() == {"rmsnorm": 1, "flash_fwd": 1}
