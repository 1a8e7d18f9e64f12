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
shape. bf16 under TMA's rule (D and F multiples of 8, buf's and w's bases
16-byte aligned) takes ``decode`` up to C = 16 tokens per expert (w
streamed through a TMA ring, ``wgmma`` with w as the wide operand, at most
one block an SM walking whole 128-column tiles: every expert's weights
read once, in order, so a call is bit-identical to the next) and
``tc_prefill`` above (TMA + ``wgmma``, persistent). bf16 that fails the
rule takes ``wmma`` (the first port's 64 x 64 tile, any shape) and f32
``fma``. The rule is by shape, chosen before the launch; a
kernel that fails raises. The kernels' design notes are in their source.

The backward (the TPU kernel has none: JAX differentiates the einsum with
XLA), no operand copied transposed: ``moe_gmm_dx_cuda`` computes
``dbuf[e] = dy[e]·w[e]ᵀ`` and ``moe_gmm_dw_cuda`` ``dw[e] = buf[e]ᵀ·dy[e]``
(contracting over the C tokens), each in f32 with one cast, by
``_bwd_variant``: ``tc`` (bf16, D and F multiples of 8, 16-byte-aligned
bases: TMA + ``wgmma`` kernels of their own, dX computed transposed in
tiles of 320 tokens, ``_bwd_plan`` picking dW's tile order), ``wmma`` (other bf16: the forward's
wmma tile on transposed layouts) or ``fma`` (f32). ``moe_gmm_bwd_plain``
is both products in PyTorch.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import build

DTYPES = (torch.float32, torch.bfloat16)
VARIANTS = ("tc_prefill", "decode", "wmma", "fma")
BWD_VARIANTS = ("tc", "wmma", "fma")
# tokens per expert up to which the decode kernel serves a call
DECODE_MAX_C = 16
# an H100's L2 cache, bytes
L2_BYTES = 50 << 20


def moe_gmm_plain(buf: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(E, C, D) x (E, D, F) -> (E, C, F): f32 product (f64 for f64 inputs),
    one cast to buf's dtype."""
    acc = torch.promote_types(buf.dtype, torch.float32)
    return torch.matmul(buf.to(acc), w.to(acc)).to(buf.dtype)


def moe_gmm_bwd_plain(buf: torch.Tensor, w: torch.Tensor, dy: torch.Tensor,
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gradients of ``moe_gmm_plain`` for dy (E, C, F): → (dbuf[e] =
    dy[e]·w[e]ᵀ in buf's dtype, dw[e] = buf[e]ᵀ·dy[e] in w's dtype); f32
    products (f64 for f64 inputs), one cast each."""
    acc = torch.promote_types(buf.dtype, torch.float32)
    dyf = dy.to(acc)
    dbuf = torch.matmul(dyf, w.to(acc).transpose(1, 2))
    dw = torch.matmul(buf.to(acc).transpose(1, 2), dyf)
    return dbuf.to(buf.dtype), dw.to(w.dtype)


def _variant(dtype: torch.dtype, C: int, D: int, F: int, aligned: bool) -> str:
    """Which kernel a (checked) call takes: by dtype, tokens per expert C,
    the widths D and F and whether buf's and w's bases are 16-byte aligned
    (TMA reads rows of D and F at 16-byte strides from such bases)."""
    if dtype == torch.float32:
        return "fma"
    if not (D % 8 == 0 and F % 8 == 0 and aligned):
        return "wmma"
    return "decode" if C <= DECODE_MAX_C else "tc_prefill"


def _bwd_plan(C: int, D: int, F: int, dw: int) -> int:
    """The tile order of the ``tc`` backward, n_fast for its C entry: 0 for
    dX (``dw`` = 0, one order). dW (M = D, N = F, K = C) walks its tiles M
    fastest, or N with n_fast = 1: where an expert's operands are small
    against L2 (both under ``L2_BYTES`` / 4), N runs fastest when N > M,
    so that the blocks that run together write whole rows of dw; otherwise
    the operand re-read once per tile of the other dim is the smaller one:
    N fastest when bufᵀ[e] (M x K) outweighs dy[e] (K x N)."""
    if not dw:
        return 0
    a_bytes, b_bytes = 2 * D * C, 2 * C * F
    if max(a_bytes, b_bytes) <= L2_BYTES // 4:
        return int(F > D)
    return int(a_bytes > b_bytes)


def _bwd_variant(dtype: torch.dtype, D: int, F: int, aligned: bool) -> str:
    """Which kernel a (checked) backward product takes: by dtype, the
    widths D and F (the rows TMA reads are D or F long) and whether its
    operands' bases are 16-byte aligned."""
    if dtype == torch.float32:
        return "fma"
    return "tc" if D % 8 == 0 and F % 8 == 0 and aligned else "wmma"


def _check(caller: str, shapes_ok: bool, want: str, *ts: torch.Tensor) -> None:
    """3-D operands of the shapes ``want`` names, of one dtype in ``DTYPES``,
    contiguous, on one CUDA device; raise otherwise."""
    if not (shapes_ok and all(t.dim() == 3 for t in ts)):
        raise ValueError(f"{caller}: want {want}, got {[tuple(t.shape) for t in ts]}")
    if ts[0].dtype not in DTYPES or any(t.dtype != ts[0].dtype for t in ts):
        raise ValueError(f"{caller}: dtypes {[str(t.dtype) for t in ts]}; want one of "
                         f"{DTYPES} for all")
    if not (ts[0].is_cuda and all(t.device == ts[0].device for t in ts)):
        raise ValueError(f"{caller}: all inputs must be on one CUDA device")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{caller}: want contiguous inputs")


def moe_gmm_cuda(buf: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Launch one kernel of ``csrc/moe_gmm.cu`` on the current stream
    (``_variant``); counts each launch in ``moe_gmm_cuda.launches`` and by
    variant in ``moe_gmm_cuda.variant_launches``."""
    _check("moe_gmm_cuda", buf.dim() == w.dim() == 3 and w.shape[0] == buf.shape[0]
           and w.shape[1] == buf.shape[2], "buf (E, C, D) and w (E, D, F)", buf, w)
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


def _bwd_launch(wrapper, caller: str, dw: int, x: torch.Tensor, y: torch.Tensor,
                out: torch.Tensor, E: int, C: int, D: int, F: int) -> torch.Tensor:
    """One backward product on the current stream: (dy, w) → dbuf for
    ``dw`` = 0, (buf, dy) → dw for 1; counted on ``wrapper``. An empty
    contraction (F for dX, C for dW) gives zeros and launches nothing."""
    if out.numel() == 0 or (C if dw else F) == 0:
        return out.zero_()
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, y))
    variant = _bwd_variant(x.dtype, D, F, aligned)
    lib = build.library()
    args = [x.data_ptr(), y.data_ptr(), out.data_ptr(), E, C, D, F, dw]
    if variant == "tc":
        args.append(_bwd_plan(C, D, F, dw))
    fn = {"tc": lib.repro_moe_gmm_bwd_bf16_tc, "wmma": lib.repro_moe_gmm_bwd_bf16,
          "fma": lib.repro_moe_gmm_bwd_f32}[variant]
    with torch.cuda.device(x.device):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    build.check(err, f"{caller} ({variant})")
    wrapper.launches += 1
    wrapper.variant_launches[variant] += 1
    return out


def moe_gmm_dx_cuda(dy: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """dbuf (E, C, D) = dy (E, C, F) · w (E, D, F)ᵀ per expert, f32
    accumulation, dy's dtype: one launch of the kernel ``_bwd_variant``
    names, counted in ``moe_gmm_dx_cuda.launches`` and by variant."""
    _check("moe_gmm_dx_cuda", dy.dim() == w.dim() == 3 and w.shape[0] == dy.shape[0]
           and w.shape[2] == dy.shape[2], "dy (E, C, F) and w (E, D, F)", dy, w)
    E, C, F = dy.shape
    D = w.shape[1]
    out = torch.empty((E, C, D), dtype=dy.dtype, device=dy.device)
    return _bwd_launch(moe_gmm_dx_cuda, "moe_gmm dx", 0, dy, w, out, E, C, D, F)


def moe_gmm_dw_cuda(buf: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """dw (E, D, F) = buf (E, C, D)ᵀ · dy (E, C, F) per expert, contracting
    over C, f32 accumulation, buf's dtype: one launch of the kernel
    ``_bwd_variant`` names, counted in ``moe_gmm_dw_cuda.launches`` and by
    variant."""
    _check("moe_gmm_dw_cuda", buf.dim() == dy.dim() == 3 and buf.shape[:2] == dy.shape[:2],
           "buf (E, C, D) and dy (E, C, F)", buf, dy)
    E, C, D = buf.shape
    F = dy.shape[2]
    out = torch.empty((E, D, F), dtype=buf.dtype, device=buf.device)
    return _bwd_launch(moe_gmm_dw_cuda, "moe_gmm dw", 1, buf, dy, out, E, C, D, F)


moe_gmm_dx_cuda.launches = moe_gmm_dw_cuda.launches = 0
moe_gmm_dx_cuda.variant_launches = dict.fromkeys(BWD_VARIANTS, 0)
moe_gmm_dw_cuda.variant_launches = dict.fromkeys(BWD_VARIANTS, 0)
