"""Flash attention forward: the plain PyTorch version and the CUDA wrapper.

The kernel (``csrc/flash_fwd.cu``) replaces the Pallas TPU kernel
``_flash_kernel`` of ``src/repro/kernels/flash_attention.py`` (wrapper
``flash_attention_fwd``). Both versions here compute that kernel's
function: scores in f32 scaled by 1/sqrt(D); causal mask aligned top-left
(``k_pos <= q_pos``, both counted from 0); sliding window
``k_pos > q_pos - window``; a valid prefix ``k_pos < kv_len`` per batch row;
GQA with kv head ``h // (Hq // Hkv)``. They return O (B, S, Hq, D) in q's
dtype and the f32 logsumexp (B*Hq, S). ``kv_len`` is the TPU kernel's
``kv_len`` parameter, which its wrapper fixes at T; here it is an optional
int32 (B,) tensor so that decode runs through the same kernel; every row
needs ``kv_len >= 1``. A query row with no valid key (a window wholly past
``kv_len``) is outside the contract: the TPU kernel's answer there depends
on which tiles it visits. Both versions here return O = 0 and lse = -1e30
for such a row, by the port's own choice.

On an H100 SXM prefill at the path's shape (S = T = 1024, D = 64) needs
about as long for its bytes as for its operations (4*S*T*D/2 per head,
causal), ~0.01 ms each; decode is bound by the bytes of the valid K/V
prefix. The kernel's design notes are in its source.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from . import build

NEG_INF = -1e30
DTYPES = (torch.float32, torch.bfloat16)
HEAD_DIMS = (32, 64, 128)


def _check_kv_len(kv_len: torch.Tensor, B: int) -> None:
    """Shape and type; ``kv_len >= 1`` for a host tensor. A device tensor is
    not read here (that would stall the stream): the kernel traps on it."""
    if kv_len.shape != (B,) or kv_len.dtype != torch.int32:
        raise ValueError(f"kv_len: want an int32 tensor of shape ({B},), got "
                         f"{kv_len.dtype} {tuple(kv_len.shape)}")
    if kv_len.device.type == "cpu" and bool((kv_len < 1).any()):
        raise ValueError("kv_len: every row needs at least one valid key")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int = 0,
                          kv_len: Optional[torch.Tensor] = None,
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q: (B, S, Hq, D); k/v: (B, T, Hkv, D) → (O (B, S, Hq, D), lse (B*Hq, S))."""
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    g = Hq // Hkv
    qh = q.float().reshape(B, S, Hkv, g, D)
    s = torch.einsum("bskgd,btkd->bkgst", qh, k.float()) * (1.0 / math.sqrt(D))
    q_pos = torch.arange(S, device=q.device)[:, None]
    k_pos = torch.arange(T, device=q.device)[None, :]
    mask = torch.ones(S, T, dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window > 0:
        mask &= k_pos > q_pos - window
    mask = mask.expand(B, S, T)
    if kv_len is not None:
        _check_kv_len(kv_len, B)
        mask = mask & (k_pos < kv_len.to(q.device).view(B, 1, 1))
    s = s.masked_fill(~mask[:, None, None], NEG_INF)
    lse = torch.logsumexp(s, dim=-1)                         # (B, Hkv, g, S)
    valid = mask.any(-1)[:, None, None, :]                   # (B, 1, 1, S)
    p = torch.exp(s - lse[..., None]) * valid[..., None]
    lse = lse.masked_fill(~valid, NEG_INF)
    o = torch.einsum("bkgst,btkd->bskgd", p, v.float())
    return o.reshape(B, S, Hq, D).to(q.dtype), lse.reshape(B * Hq, S)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0,
                         kv_len: Optional[torch.Tensor] = None,
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/flash_fwd.cu`` on the current stream; counts each launch
    in ``flash_attention_cuda.launches``. q, k, v may be strided views as
    long as their last dim is contiguous (e.g. a KV-cache slice). A host
    ``kv_len`` is checked (``>= 1``) and copied over; on a device one below
    1 the kernel traps, and the launch fails."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("flash_attention_cuda: want q (B,S,Hq,D), k/v (B,T,Hkv,D)")
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or Hkv == 0 or Hq % Hkv:
        raise ValueError(f"flash_attention_cuda: shapes {tuple(q.shape)} "
                         f"{tuple(k.shape)} do not match")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention_cuda: head dim {D} not in {HEAD_DIMS}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention_cuda: dtypes {q.dtype}/{k.dtype}/"
                         f"{v.dtype}; want one of {DTYPES} for all")
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention_cuda: q, k, v must be on one CUDA device")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("flash_attention_cuda: the head dim must be contiguous")
    if kv_len is not None:
        _check_kv_len(kv_len, B)
        kv_len = kv_len.to(q.device).contiguous()
    o = torch.empty((B, S, Hq, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B * Hq, S), dtype=torch.float32, device=q.device)
    if B == 0 or S == 0 or T == 0:
        return o, lse
    lib = build.library()
    fn = (lib.repro_flash_fwd_bf16 if q.dtype == torch.bfloat16
          else lib.repro_flash_fwd_f32)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), kv_len.data_ptr() if kv_len is not None else None,
                 B, S, T, Hq, Hkv, D,
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 int(causal), int(window), 1.0 / math.sqrt(D), stream)
    build.check(err, "flash_fwd")
    flash_attention_cuda.launches += 1
    return o, lse


flash_attention_cuda.launches = 0
