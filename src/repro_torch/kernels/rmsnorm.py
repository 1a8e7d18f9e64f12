"""Fused RMSNorm: the plain PyTorch version and the CUDA kernel's wrapper.

The kernel (``csrc/rmsnorm.cu``) replaces the Pallas TPU kernel
``_rmsnorm_kernel`` of ``src/repro/kernels/rmsnorm.py``. Both versions here
compute that kernel's function (= ``repro.kernels.ref.rmsnorm_ref``): the
row-wise f32 mean of squares, ``rsqrt(ms + eps)``, times the scale in f32,
and one cast to x's dtype. It is bound by bytes on the card (each element
read and written once); one block per row reduces in f32 and writes once.
"""
from __future__ import annotations

import torch

from . import build

DTYPES = (torch.float32, torch.bfloat16)


def rmsnorm_plain(x: torch.Tensor, scale: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """f32 inside (f64 for f64 inputs, as gradcheck needs)."""
    acc = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(acc)
    ms = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale.to(acc)).to(x.dtype)


def rmsnorm_cuda(x: torch.Tensor, scale: torch.Tensor,
                 eps: float = 1e-6) -> torch.Tensor:
    """Launch ``csrc/rmsnorm.cu`` on the current stream; counts each launch
    in ``rmsnorm_cuda.launches``."""
    if not (x.is_cuda and scale.is_cuda and x.device == scale.device):
        raise ValueError("rmsnorm_cuda: x and scale must be on one CUDA device")
    if x.dtype not in DTYPES or scale.dtype != x.dtype:
        raise ValueError(f"rmsnorm_cuda: dtypes {x.dtype}/{scale.dtype}; "
                         f"want one of {DTYPES} for both")
    d = x.shape[-1]
    if scale.shape != (d,) or not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("rmsnorm_cuda: want contiguous x (..., d) and scale (d,)")
    out = torch.empty_like(x)
    rows = x.numel() // d if d else 0
    if rows == 0:
        return out
    fn = (build.library().repro_rmsnorm_bf16 if x.dtype == torch.bfloat16
          else build.library().repro_rmsnorm_f32)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), scale.data_ptr(), out.data_ptr(), rows, d,
                 float(eps), stream)
    build.check(err, "rmsnorm")
    rmsnorm_cuda.launches += 1
    return out


rmsnorm_cuda.launches = 0
