"""The reference's parts that every family shares, in plain PyTorch: the
precision it multiplies in (``Prec``), RMSNorm, RoPE, causal attention,
the output head, and the calls a served request went through. A family's
layer (``families/<family>.py`` ``block``) is built from them."""
from __future__ import annotations

import math
from typing import List, Tuple

import torch

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def strict_f32() -> None:
    """float32 products in float32: no TF32 anywhere."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _round8(x: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    """x rounded to a float8 type with one scale for the tensor."""
    amax = x.detach().abs().amax().clamp(min=1e-30)
    s = amax / top
    return (x / s).to(dtype).to(x.dtype) * s


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        qa, qb = _round8(a, torch.float8_e4m3fn, E4M3_MAX), _round8(b, torch.float8_e4m3fn, E4M3_MAX)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = _round8(g, torch.float8_e5m2, E5M2_MAX)
        ga = qg @ qb.transpose(-1, -2)
        gb = qa.reshape(-1, qa.shape[-1]).transpose(0, 1) @ qg.reshape(-1, qg.shape[-1])
        return ga, gb.reshape(qb.shape)


class Prec:
    """How the reference multiplies: ``f32`` (the reference) or ``fp8``
    (the control)."""

    def __init__(self, kind: str = "f32") -> None:
        if kind not in ("f32", "fp8"):
            raise ValueError(kind)
        self.kind = kind

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        b = b.float()
        if self.kind == "f32":
            return a @ b
        return _Fp8Matmul.apply(a, b)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w.float()


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, H, D), positions (S,): each half of D rotated against the
    other, frequency theta^(-2i/D)."""
    D = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, D, 2, dtype=torch.float32, device=x.device) / D))
    ang = positions.float()[:, None] * freqs[None, :]              # (S, D/2)
    cos, sin = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :]
    x1, x2 = x[..., : D // 2], x[..., D // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int,
              q_block: int = 512) -> torch.Tensor:
    """Causal softmax attention, q (B, S, Hq, D) against k, v (B, S, Hkv, D)
    (query head h reads key head h // (Hq / Hkv)); key j is seen from query
    i when j <= i and, with a window, i - j < window. Blocks of queries,
    each against the keys up to its last row."""
    B, S, Hq, D = q.shape
    g = Hq // k.shape[2]
    k = k.repeat_interleave(g, dim=2).transpose(1, 2)              # (B, Hq, S, D)
    v = v.repeat_interleave(g, dim=2).transpose(1, 2)
    q = q.transpose(1, 2)
    outs = []
    for i0 in range(0, S, q_block):
        i1 = min(S, i0 + q_block)
        qi = torch.arange(i0, i1, device=q.device)[:, None]
        kj = torch.arange(i1, device=q.device)[None, :]
        seen = kj <= qi
        if window > 0:
            seen = seen & (kj > qi - window)
        s = (q[:, :, i0:i1] @ k[:, :, :i1].transpose(-1, -2)) / math.sqrt(D)
        s = s.masked_fill(~seen, float("-inf"))
        outs.append(torch.softmax(s, dim=-1) @ v[:, :, :i1])
    return torch.cat(outs, dim=2).transpose(1, 2)


def unembed(x: torch.Tensor, final_norm: torch.Tensor, lm_head: torch.Tensor, eps: float,
            prec: Prec) -> torch.Tensor:
    return prec.mm(rmsnorm(x, final_norm, eps), lm_head)


def served_segments(prompt_len: int, total: int) -> List[Tuple[int, int, bool]]:
    """A served request's calls, as (start, end, drops): the admission
    prefill of prompt[:-1] (a call that may drop), then one token a decode
    round (calls that never drop)."""
    segs = []
    if prompt_len > 1:
        segs.append((0, prompt_len - 1, True))
    segs.append((prompt_len - 1, total, False))
    return segs

