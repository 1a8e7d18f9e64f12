"""Public kernel entry points of the port: dispatch by the tensor's device.

A CPU tensor takes the kernel's plain PyTorch version (the tests run there);
a CUDA tensor launches the hand-written kernel or raises. There is no
fallback from one to the other and no switch. Each CUDA wrapper counts its
launches; ``launch_counts`` reads the counts (``flash_variant_counts`` the
forward flash kernel's by variant, ``flash_bwd_variant_counts`` the
backward's, ``moe_gmm_variant_counts`` the grouped GEMM's,
``moe_gmm_bwd_variant_counts`` its backward's, ``ssd_scan_variant_counts``
the SSD scan's, ``ssd_scan_bwd_variant_counts`` its backward's) and
``reset_launch_counts`` sets them all to 0, so a run can show that its path
went through the kernels.

All four entry points are differentiable: where grad is enabled and an
input requires it, they go through a ``torch.autograd.Function`` whose
forward is the same dispatch and whose backward is a kernel on the card
(the flash backward's dq and dk/dv; the grouped GEMM's dX and dW; the SSD
scan's backward) and its plain version on the CPU; RMSNorm's backward is
plain PyTorch (JAX leaves its gradient to XLA: there is no Pallas kernel to
port). JAX's Pallas kernels have no VJP for the grouped GEMM and the SSD
scan; JAX takes those gradients with XLA, the port with hand-written
kernels. Elsewhere (serving) the entry points call the forward dispatch
directly, so the Function layer adds no launch there.

On a device mesh the entry points take DTensors. A compiled kernel cannot
read a DTensor, so each entry point states the placements its kernel takes
per mesh dim, redistributes its inputs to them where they differ (each
such redistribution is named below), and runs the same dispatch on every
rank's local shard through ``local_map``; the device of the local tensor
decides kernel or plain version, as for a plain tensor. Where a rank's
query heads are sharded while the KV heads are replicated (GQA whose KV
head count does not divide the "model" extent), the rank hands its kernel
only the KV heads its query heads use.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from ..shards import local_shape_and_offset, place
from .flash_attention import (
    flash_attention_bwd_cuda,
    flash_attention_bwd_plain,
    flash_attention_cuda,
    flash_attention_plain,
    flash_bwd_dkv_cuda,
    flash_bwd_dq_cuda,
)
from .moe_gmm import (
    moe_gmm_bwd_plain,
    moe_gmm_cuda,
    moe_gmm_dw_cuda,
    moe_gmm_dx_cuda,
    moe_gmm_plain,
)
from .rmsnorm import rmsnorm_cuda, rmsnorm_plain
from .ssd_scan import ssd_scan_bwd_cuda, ssd_scan_bwd_plain, ssd_scan_cuda, ssd_scan_plain

_CUDA_WRAPPERS = {"rmsnorm": rmsnorm_cuda, "flash_fwd": flash_attention_cuda,
                  "flash_bwd_dq": flash_bwd_dq_cuda,
                  "flash_bwd_dkv": flash_bwd_dkv_cuda, "moe_gmm": moe_gmm_cuda,
                  "moe_gmm_dx": moe_gmm_dx_cuda, "moe_gmm_dw": moe_gmm_dw_cuda,
                  "ssd_scan": ssd_scan_cuda, "ssd_scan_bwd": ssd_scan_bwd_cuda}


def _on_cuda(t: torch.Tensor, name: str) -> bool:
    if t.device.type == "cpu":
        return False
    if t.device.type == "cuda":
        return True
    raise ValueError(f"{name}: no kernel for device {t.device}")


def _needs_grad(*ts: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------
def rmsnorm_fwd(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last dim, f32 statistics, one cast to x's dtype."""
    if _on_cuda(x, "rmsnorm"):
        return rmsnorm_cuda(x, scale, eps)
    return rmsnorm_plain(x, scale, eps)


def rmsnorm_bwd(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor,
                eps: float = 1e-6) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gradient of y = x̂·s, x̂ = x·r, r = rsqrt(mean(x²) + eps), in f32 (f64
    for f64): ds = Σ_rows g·x̂, dx = r·(g·s − x̂·mean(g·s·x̂)). → (dx in x's
    dtype, ds in scale's dtype)."""
    acc = torch.promote_types(x.dtype, torch.float32)
    xf, gf, sf = x.to(acc), g.to(acc), scale.to(acc)
    r = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    xhat = xf * r
    gs = gf * sf
    dx = r * (gs - xhat * (gs * xhat).mean(-1, keepdim=True))
    ds = (gf * xhat).reshape(-1, x.shape[-1]).sum(0)
    return dx.to(x.dtype), ds.to(scale.dtype)


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return rmsnorm_fwd(x, scale, eps)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        dx, ds = rmsnorm_bwd(x, scale, g, ctx.eps)
        return dx, ds, None


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last dim, f32 statistics, one cast to x's dtype;
    differentiable."""
    if isinstance(x, DTensor):
        return _sharded_rmsnorm(x, scale, eps)
    if _needs_grad(x, scale):
        return _RMSNorm.apply(x, scale, eps)
    return rmsnorm_fwd(x, scale, eps)


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------
def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool, window: int,
                        kv_len: Optional[torch.Tensor] = None,
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (O (B, S, Hq, D), lse (B*Hq, S) f32); see ``kernels.flash_attention``."""
    if _on_cuda(q, "flash_attention_fwd"):
        return flash_attention_cuda(q, k, v, causal=causal, window=window,
                                    kv_len=kv_len)
    return flash_attention_plain(q, k, v, causal=causal, window=window,
                                 kv_len=kv_len)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
                        causal: bool, window: int,
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """→ (dq, dk, dv) from the forward's O and lse; see ``kernels.flash_attention``."""
    if _on_cuda(q, "flash_attention_bwd"):
        return flash_attention_bwd_cuda(q, k, v, o, lse, do, causal=causal,
                                        window=window)
    return flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                     window=window)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        o, lse = flash_attention_fwd(q, k, v, causal=causal, window=window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, causal=ctx.causal,
                                         window=ctx.window)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """Differentiable flash attention (JAX's ``ops.flash_attention``):
    q (B, S, Hq, D), k/v (B, T, Hkv, D) → O (B, S, Hq, D)."""
    if isinstance(q, DTensor):
        return _sharded_flash_attention(q, k, v, causal, window)
    if _needs_grad(q, k, v):
        return _FlashAttention.apply(q, k, v, causal, window)
    return flash_attention_fwd(q, k, v, causal=causal, window=window)[0]


# ---------------------------------------------------------------------------
# grouped expert GEMM
# ---------------------------------------------------------------------------
def moe_gmm_fwd(buf: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(E, C, D) x (E, D, F) -> (E, C, F); see ``kernels.moe_gmm``."""
    if _on_cuda(buf, "moe_gmm"):
        return moe_gmm_cuda(buf, w)
    return moe_gmm_plain(buf, w)


def moe_gmm_bwd(buf: torch.Tensor, w: torch.Tensor, dy: torch.Tensor,
                need_dbuf: bool = True, need_dw: bool = True,
                ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """→ (dbuf = dy·wᵀ, dw = bufᵀ·dy) per expert, each only where asked for:
    the dX and dW kernels on the card, ``moe_gmm_bwd_plain`` on the CPU."""
    if _on_cuda(buf, "moe_gmm_bwd"):
        dy = dy.contiguous()
        return (moe_gmm_dx_cuda(dy, w) if need_dbuf else None,
                moe_gmm_dw_cuda(buf, dy) if need_dw else None)
    dbuf, dw = moe_gmm_bwd_plain(buf, w, dy)
    return (dbuf if need_dbuf else None), (dw if need_dw else None)


class _MoEGmm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, buf, w):
        ctx.save_for_backward(buf, w)
        return moe_gmm_fwd(buf, w)

    @staticmethod
    def backward(ctx, dy):
        buf, w = ctx.saved_tensors
        return moe_gmm_bwd(buf, w, dy, *ctx.needs_input_grad)


def moe_gmm(buf: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(E, C, D) x (E, D, F) -> (E, C, F), f32 accumulation, buf's dtype;
    differentiable (dX and dW through the backward kernels on the card)."""
    if isinstance(w, DTensor):
        return _sharded_moe_gmm(buf, w)
    if _needs_grad(buf, w):
        return _MoEGmm.apply(buf, w)
    return moe_gmm_fwd(buf, w)


# ---------------------------------------------------------------------------
# Mamba2 SSD chunked scan
# ---------------------------------------------------------------------------
def ssd_scan_fwd(xh: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, B_: torch.Tensor,
                 C_: torch.Tensor, chunk: int = 256) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (y, final state); see ``ssd_scan``."""
    if _on_cuda(xh, "ssd_scan"):
        return ssd_scan_cuda(xh, dt, a, B_, C_)
    return ssd_scan_plain(xh, dt, a, B_, C_, chunk)


def ssd_scan_bwd(xh: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, B_: torch.Tensor,
                 C_: torch.Tensor, dy: Optional[torch.Tensor],
                 dh_final: Optional[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
    """→ (dxh, ddt, da, dB, dC) for the gradients of y and of the final
    state (None is zero): the backward kernel on the card,
    ``ssd_scan_bwd_plain`` on the CPU."""
    if dy is None:
        dy = torch.zeros_like(xh)
    if _on_cuda(xh, "ssd_scan_bwd"):
        return ssd_scan_bwd_cuda(xh, dt, a, B_, C_, dy.contiguous(), dh_final)
    return ssd_scan_bwd_plain(xh, dt, a, B_, C_, dy, dh_final)


class _SSDScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xh, dt, a, B_, C_, chunk):
        ctx.set_materialize_grads(False)   # an unused final state costs nothing
        ctx.save_for_backward(xh, dt, a, B_, C_)
        return ssd_scan_fwd(xh, dt, a, B_, C_, chunk)

    @staticmethod
    def backward(ctx, dy, dh_final):
        grads = ssd_scan_bwd(*ctx.saved_tensors, dy, dh_final)
        return (*grads, None)


def ssd_scan(xh: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, B_: torch.Tensor,
             C_: torch.Tensor, *, chunk: int = 256) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (y (B, S, H, P) in xh's dtype, final state (B, H, P, N) f32); see
    ``kernels.ssd_scan``. ``chunk`` is the plain version's chunk length (the
    kernels keep their own: 128-row chunks in bf16, 64-row tiles in f32;
    the result is the same up to rounding). Differentiable in both outputs
    (the backward kernel on the card)."""
    if isinstance(xh, DTensor):
        return _sharded_ssd_scan(xh, dt, a, B_, C_, chunk)
    if _needs_grad(xh, dt, a, B_, C_):
        return _SSDScan.apply(xh, dt, a, B_, C_, chunk)
    return ssd_scan_fwd(xh, dt, a, B_, C_, chunk)


# ---------------------------------------------------------------------------
# the entry points on a device mesh: local_map over each rank's shard
# ---------------------------------------------------------------------------
def _keep(placements, allowed) -> Tuple:
    """``placements`` with every one not in ``allowed`` made Replicate."""
    return tuple(p if p in allowed else Replicate() for p in placements)


def _grad_partial_where_split(placements, split) -> Tuple:
    """The gradient placements of an input that is ``placements`` on each
    mesh dim: Partial where the other operand splits the work on that dim
    (``split[i]``), else the input's own."""
    return tuple(Partial() if s else p for p, s in zip(placements, split))


def _sharded_rmsnorm(x: DTensor, scale: DTensor, eps: float) -> DTensor:
    """Rows may be sharded on any mesh dim; the normalised (last) dim must
    be whole: a shard of it is gathered first. The scale is replicated; its
    gradient sums over the rows, so it is Partial where the rows are split."""
    mesh = x.device_mesh
    xp = tuple(Replicate() if isinstance(p, Partial) or p == Shard(x.ndim - 1) else p
               for p in x.placements)
    rep = (Replicate(),) * mesh.ndim
    x = place(x, xp)                                   # gather a split norm dim
    scale = place(scale, rep)
    ds_pl = _grad_partial_where_split(rep, [isinstance(p, Shard) for p in xp])
    return local_map(rmsnorm, out_placements=list(xp), in_placements=(xp, rep, None),
                     in_grad_placements=(xp, ds_pl, None), device_mesh=mesh)(x, scale, eps)


def _sharded_flash_attention(q: DTensor, k: DTensor, v: DTensor, causal: bool,
                             window: int) -> DTensor:
    """Batch (dim 0) and heads (dim 2) may be sharded; the sequence and the
    head dim are gathered first. K/V follow q's placements; where q's heads
    are split on a mesh dim but K/V's are replicated there (their head
    count does not divide the extent), every rank keeps all KV heads and
    slices out those its query heads use, ``[h0 // G, (h0 + h - 1) // G]``
    for its h query heads from global head h0 and group size G; their
    gradients are then Partial on that dim (each rank's covers its slice)."""
    mesh = q.device_mesh
    allowed = (Shard(0), Shard(2))
    qp = _keep(q.placements, allowed)
    slice_dims = [p == Shard(2) and k.placements[i] != Shard(2) for i, p in enumerate(qp)]
    kvp = tuple(Replicate() if s else p for p, s in zip(qp, slice_dims))
    # the sequence all-gather before attention (a sequence-sharded residual)
    q, k, v = place(q, qp), place(k, kvp), place(v, kvp)
    fn = functools.partial(flash_attention, causal=causal, window=window)
    if any(slice_dims):
        hq, hkv = q.shape[2], k.shape[2]
        shape, offset = local_shape_and_offset(q.shape, mesh, qp)
        h0, h = offset[2], shape[2]
        group = hq // hkv
        lo, hi = h0 // group, (h0 + h - 1) // group + 1
        if hi - lo > 1 and (h0 % group or h % group):
            raise ValueError(f"query heads {h0}..{h0 + h - 1} do not map onto whole "
                             f"KV heads (group {group})")

        def fn(ql, kl, vl):
            return flash_attention(ql, kl[:, :, lo:hi], vl[:, :, lo:hi], causal=causal,
                                   window=window)
    kv_grad = _grad_partial_where_split(kvp, slice_dims)
    return local_map(fn, out_placements=list(qp), in_placements=(qp, kvp, kvp),
                     in_grad_placements=(qp, kv_grad, kv_grad), device_mesh=mesh)(q, k, v)


def _gmm_placements(bp, wp) -> Tuple[object, object, object, object, object]:
    """On one mesh dim, from the operands' placements: → (buf's, w's, the
    output's, buf's gradient's, w's gradient's). Experts split both
    (Shard 0); F split on w gives F-split outputs; D split on both gives
    partial sums; C split on buf gives C-split outputs."""
    if wp == Shard(0):
        return Shard(0), Shard(0), Shard(0), Shard(0), Shard(0)
    if wp == Shard(2):
        return Replicate(), Shard(2), Shard(2), Partial(), Shard(2)
    if wp == Shard(1):
        return Shard(2), Shard(1), Partial(), Shard(2), Shard(1)
    if bp == Shard(1):
        return Shard(1), Replicate(), Shard(1), Shard(1), Partial()
    return Replicate(), Replicate(), Replicate(), Replicate(), Replicate()


def _sharded_moe_gmm(buf: DTensor, w: DTensor) -> DTensor:
    """The grouped GEMM on each rank's shard: per mesh dim by
    ``_gmm_placements``; buf is redistributed to what w's placement asks
    (its expert or D shard is a local slice of a replicated buffer)."""
    mesh = w.device_mesh
    if not isinstance(buf, DTensor):
        buf = DTensor.from_local(buf, mesh, (Replicate(),) * mesh.ndim, run_check=False)
    wp0 = tuple(p if isinstance(p, Shard) else Replicate() for p in w.placements)
    plan = [_gmm_placements(b, wq) for b, wq in zip(buf.placements, wp0)]
    bp, wp, op, bg, wg = (tuple(t) for t in zip(*plan))
    buf, w = place(buf, bp), place(w, wp)
    return local_map(moe_gmm, out_placements=list(op), in_placements=(bp, wp),
                     in_grad_placements=(bg, wg), device_mesh=mesh)(buf, w)


def _sharded_ssd_scan(xh: DTensor, dt: DTensor, a: DTensor, B_: DTensor, C_: DTensor,
                      chunk: int) -> Tuple[DTensor, DTensor]:
    """The scan on each rank's rows: the batch (dim 0) may be sharded; every
    other dim is gathered first, and ``a`` (per head) replicated."""
    mesh = xh.device_mesh
    bp = _keep(xh.placements, (Shard(0),))
    rep = (Replicate(),) * mesh.ndim
    xh, dt, B_, C_ = (place(t, bp) for t in (xh, dt, B_, C_))
    a = place(a, rep)
    a_grad = _grad_partial_where_split(rep, [p == Shard(0) for p in bp])
    fn = functools.partial(ssd_scan, chunk=chunk)
    return local_map(fn, out_placements=(list(bp), list(bp)), in_placements=(bp, bp, rep, bp, bp),
                     in_grad_placements=(bp, bp, a_grad, bp, bp),
                     device_mesh=mesh)(xh, dt, a, B_, C_)


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in _CUDA_WRAPPERS.items()}


def flash_variant_counts() -> Dict[str, int]:
    """The forward flash launches by kernel variant (``tc_prefill``,
    ``split_decode``, ``fma``); they sum to ``launch_counts()["flash_fwd"]``."""
    return dict(flash_attention_cuda.variant_launches)


def moe_gmm_variant_counts() -> Dict[str, int]:
    """The grouped GEMM's launches by kernel variant (``tc_prefill``,
    ``decode``, ``wmma``, ``fma``); they sum to ``launch_counts()["moe_gmm"]``."""
    return dict(moe_gmm_cuda.variant_launches)


def flash_bwd_variant_counts() -> Dict[str, Dict[str, int]]:
    """The backward flash launches by kernel variant (``tc``: bf16 on tensor
    cores, ``fma``: f32), for ``flash_bwd_dq`` and ``flash_bwd_dkv``; each
    sums to that kernel's ``launch_counts()`` entry."""
    return {name: dict(_CUDA_WRAPPERS[name].variant_launches)
            for name in ("flash_bwd_dq", "flash_bwd_dkv")}


def moe_gmm_bwd_variant_counts() -> Dict[str, Dict[str, int]]:
    """The grouped GEMM's backward launches by kernel variant (``tc``: bf16
    on TMA + ``wgmma``, ``wmma``: other bf16, ``fma``: f32), for
    ``moe_gmm_dx`` and ``moe_gmm_dw``; each sums to that kernel's
    ``launch_counts()`` entry."""
    return {name: dict(_CUDA_WRAPPERS[name].variant_launches)
            for name in ("moe_gmm_dx", "moe_gmm_dw")}


def ssd_scan_bwd_variant_counts() -> Dict[str, int]:
    """The SSD backward's calls by kernel variant (``tc``: bf16, chunks in
    parallel on tensor cores; ``fma``: f32); they sum to
    ``launch_counts()["ssd_scan_bwd"]``."""
    return dict(ssd_scan_bwd_cuda.variant_launches)


def ssd_scan_variant_counts() -> Dict[str, int]:
    """The SSD scan's launches by kernel variant (``tc``: bf16, ``fma``:
    f32); they sum to ``launch_counts()["ssd_scan"]``."""
    return dict(ssd_scan_cuda.variant_launches)


def reset_launch_counts() -> None:
    for fn in _CUDA_WRAPPERS.values():
        fn.launches = 0
        for name in getattr(fn, "variant_launches", ()):
            fn.variant_launches[name] = 0
