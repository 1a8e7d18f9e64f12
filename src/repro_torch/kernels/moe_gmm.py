"""Grouped expert GEMM (MoE FFN): the plain PyTorch version and the CUDA
kernel's wrapper.

The kernel (``csrc/moe_gmm.cu``) replaces the Pallas TPU kernel
``_gmm_kernel`` of ``src/repro/kernels/moe_gmm.py`` (wrapper
``moe_gmm_pallas``). Both versions here compute that kernel's function
(= ``repro.kernels.ref.moe_gmm_ref``, the expert einsum ``ecd,edf->ecf``):
``out[e] = buf[e] @ w[e]`` for buf (E, C, D) and w (E, D, F), accumulated in
f32 and cast once to buf's dtype.

On the card a decode round is bound by w's bytes: with C tokens per expert
at most 16, every expert's weights are read once for a handful of rows
(qwen3-moe-30b-a3b: 403 MB of w per call, ~0.12 ms at 3.35 TB/s). The
kernel's design notes are in its source.
"""
from __future__ import annotations

import torch

from . import build

DTYPES = (torch.float32, torch.bfloat16)


def moe_gmm_plain(buf: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(E, C, D) x (E, D, F) -> (E, C, F): f32 product (f64 for f64 inputs),
    one cast to buf's dtype."""
    acc = torch.promote_types(buf.dtype, torch.float32)
    return torch.matmul(buf.to(acc), w.to(acc)).to(buf.dtype)


def moe_gmm_cuda(buf: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/moe_gmm.cu`` on the current stream; counts each launch
    in ``moe_gmm_cuda.launches``."""
    if buf.dim() != 3 or w.dim() != 3 or w.shape[0] != buf.shape[0] \
            or w.shape[1] != buf.shape[2]:
        raise ValueError(f"moe_gmm_cuda: want buf (E, C, D) and w (E, D, F), got "
                         f"{tuple(buf.shape)} and {tuple(w.shape)}")
    if buf.dtype not in DTYPES or w.dtype != buf.dtype:
        raise ValueError(f"moe_gmm_cuda: dtypes {buf.dtype}/{w.dtype}; want one of "
                         f"{DTYPES} for both")
    if not (buf.is_cuda and w.device == buf.device):
        raise ValueError("moe_gmm_cuda: buf and w must be on one CUDA device")
    if not (buf.is_contiguous() and w.is_contiguous()):
        raise ValueError("moe_gmm_cuda: want contiguous buf and w")
    E, C, D = buf.shape
    F = w.shape[2]
    out = torch.empty((E, C, F), dtype=buf.dtype, device=buf.device)
    if out.numel() == 0:
        return out
    lib = build.library()
    fn = lib.repro_moe_gmm_bf16 if buf.dtype == torch.bfloat16 else lib.repro_moe_gmm_f32
    with torch.cuda.device(buf.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(buf.data_ptr(), w.data_ptr(), out.data_ptr(), E, C, D, F, stream)
    build.check(err, "moe_gmm")
    moe_gmm_cuda.launches += 1
    return out


moe_gmm_cuda.launches = 0
