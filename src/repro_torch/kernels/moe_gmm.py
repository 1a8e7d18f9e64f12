"""Grouped expert GEMM (MoE FFN): the plain PyTorch version and the CUDA
kernels' wrapper.

The kernels (``csrc/moe_gmm.cu``) replace the Pallas TPU kernel
``_gmm_kernel`` of ``src/repro/kernels/moe_gmm.py`` (wrapper
``moe_gmm_pallas``). Both versions here compute that kernel's function
(= ``repro.kernels.ref.moe_gmm_ref``, the expert einsum ``ecd,edf->ecf``):
``out[e] = buf[e] @ w[e]`` for buf (E, C, D) and w (E, D, F), accumulated in
f32 and cast once to buf's dtype.

On the card a call is bound by w's bytes (qwen3-moe-30b-a3b: 403 MB of w
per call, ~0.12 ms at 3.35 TB/s); at a prefill step's C = 320 about as much
by its operations. ``_variant`` picks one of four kernels by dtype and
shape: ``tc_prefill`` (bf16, C > 16, D and F multiples of 8, 16-byte-aligned
bases: TMA + ``wgmma``, persistent), ``decode`` (bf16, C <= 16: a 16-row
``wmma`` tile that reads every weight once), ``wmma`` (bf16, C > 16 where
the TMA rule fails: the first port's 64 x 64 tile) and ``fma`` (f32). The
kernels' design notes are in their source.
"""
from __future__ import annotations

import torch

from . import build

DTYPES = (torch.float32, torch.bfloat16)
VARIANTS = ("tc_prefill", "decode", "wmma", "fma")
# tokens per expert up to which the 16-row decode tile serves a call
DECODE_MAX_C = 16


def moe_gmm_plain(buf: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(E, C, D) x (E, D, F) -> (E, C, F): f32 product (f64 for f64 inputs),
    one cast to buf's dtype."""
    acc = torch.promote_types(buf.dtype, torch.float32)
    return torch.matmul(buf.to(acc), w.to(acc)).to(buf.dtype)


def _variant(dtype: torch.dtype, C: int, D: int, F: int, aligned: bool) -> str:
    """Which kernel a (checked) call takes: by dtype, tokens per expert C,
    the widths D and F and whether buf's and w's bases are 16-byte aligned
    (TMA reads rows of D and F at 16-byte strides from such bases)."""
    if dtype == torch.float32:
        return "fma"
    if C <= DECODE_MAX_C:
        return "decode"
    if D % 8 == 0 and F % 8 == 0 and aligned:
        return "tc_prefill"
    return "wmma"


def moe_gmm_cuda(buf: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Launch one kernel of ``csrc/moe_gmm.cu`` on the current stream
    (``_variant``); counts each launch in ``moe_gmm_cuda.launches`` and by
    variant in ``moe_gmm_cuda.variant_launches``."""
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
    variant = _variant(buf.dtype, C, D, F,
                       buf.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0)
    lib = build.library()
    fn = {"tc_prefill": lib.repro_moe_gmm_bf16_tc, "decode": lib.repro_moe_gmm_bf16_decode,
          "wmma": lib.repro_moe_gmm_bf16, "fma": lib.repro_moe_gmm_f32}[variant]
    with torch.cuda.device(buf.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(buf.data_ptr(), w.data_ptr(), out.data_ptr(), E, C, D, F, stream)
    build.check(err, f"moe_gmm ({variant})")
    moe_gmm_cuda.launches += 1
    moe_gmm_cuda.variant_launches[variant] += 1
    return out


moe_gmm_cuda.launches = 0
moe_gmm_cuda.variant_launches = dict.fromkeys(VARIANTS, 0)
