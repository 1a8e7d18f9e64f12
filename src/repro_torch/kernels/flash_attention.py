"""Flash attention forward and backward: plain PyTorch versions and the
CUDA wrappers.

The forward kernel (``csrc/flash_fwd.cu``) replaces the Pallas TPU kernel
``_flash_kernel`` of ``src/repro/kernels/flash_attention.py`` (wrapper
``flash_attention_fwd``). Both forward versions here compute that kernel's
function: scores in f32 scaled by 1/sqrt(D); causal mask aligned top-left
(``k_pos <= q_pos``, both counted from 0); sliding window
``k_pos > q_pos - window``; a valid prefix ``k_pos < kv_len`` per batch row;
GQA with kv head ``h // (Hq // Hkv)``. They return O (B, S, Hq, D) in q's
dtype and the f32 logsumexp (B*Hq, S) (the plain version computes in f64
for f64 inputs, as gradcheck needs). ``kv_len`` is the TPU kernel's
``kv_len`` parameter, which its wrapper fixes at T; here it is an optional
int32 (B,) tensor so that decode runs through the same kernel; every row
needs ``kv_len >= 1``. A query row with no valid key (a window wholly past
``kv_len``) is outside the contract: the TPU kernel's answer there depends
on which tiles it visits. Both versions here return O = 0 and lse = -1e30
for such a row, by the port's own choice.

``flash_attention_cuda`` takes one of three hand-written kernels of
``csrc/flash_fwd.cu`` by dtype and shape, a documented choice and never a
fallback from a kernel that failed (``_variant``):

- ``tc_prefill``: bf16 with more than ``DECODE_MAX_ROWS`` query rows (or a
  GQA group too large for the decode block): TMA loads and ``wgmma`` tensor
  cores. On an H100 SXM prefill at S = T = 1024 needs about as long for its
  operations as for its bytes.
- ``split_decode``: bf16 with S <= ``DECODE_MAX_ROWS`` and
  (Hq/Hkv)·S <= ``DECODE_MAX_GROUP_ROWS``: split-KV, one block per
  (batch row, KV head, chunk of ``_decode_plan(T)``), each KV head read
  once, the chunks' partials merged in the same launch. Bound by the bytes
  of the valid K/V prefix. ``flash_decode_split_plain`` computes its
  partials and merge in PyTorch, for the tests.
- ``fma``: f32, any shape: f32 FMAs.

The bf16 kernels read q, k and v through TMA or 16-byte ``cp.async``: each
base pointer and each stride of a dim longer than 1 must be a multiple of
16 bytes, or the wrapper raises. The kernels' design notes are in their
source.

The backward kernels (``csrc/flash_bwd.cu``: ``flash_bwd_dq``,
``flash_bwd_dkv``) replace ``_flash_bwd_dq_kernel`` and
``_flash_bwd_dkv_kernel`` (wrapper ``flash_attention_bwd``): from the
forward's O and lse they give dq, dk and dv, dk/dv summed over the GQA
group. As in JAX's backward there is no ``kv_len``: every key below T is
valid. Δ = rowsum(dO∘O) is a PyTorch reduction in the wrapper, as JAX
computes it in XLA outside its kernels. Each of the two takes one of two
kernels by dtype, a documented choice like the forward's (``_bwd_variant``):
``tc`` (bf16: TMA loads and ``wgmma`` tensor cores, P and dS rounded to
bf16 for the second products) or ``fma`` (f32: f32 FMAs).

Both directions take every head dim in ``HEAD_DIMS``; any other raises.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensor

from . import build

NEG_INF = -1e30
DTYPES = (torch.float32, torch.bfloat16)
# the head dims of the forward and backward kernels: every config's (32 the
# smoke models', 64, 80 zamba2's shared block, 96 phi-3-vision, 128, 256
# gemma3-12b)
HEAD_DIMS = (32, 64, 80, 96, 128, 256)
DECODE_MAX_ROWS = 4          # S up to this takes the split-KV decode kernel (bf16)
DECODE_MAX_GROUP_ROWS = 32   # ... when its block's Hq/Hkv · S query rows fit
DECODE_CHUNK = 256           # keys a decode block takes (a multiple of 4 warps x 32 keys)
VARIANTS = ("tc_prefill", "split_decode", "fma")
BWD_VARIANTS = ("tc", "fma")


def _acc_dtype(t: torch.Tensor) -> torch.dtype:
    """The plain versions compute in f32, or in f64 for f64 inputs (gradcheck)."""
    return torch.promote_types(t.dtype, torch.float32)


def _check_kv_len(kv_len: torch.Tensor, B: int) -> None:
    """Shape and type; ``kv_len >= 1`` for a host tensor. A device tensor is
    not read here (that would stall the stream): the kernel traps on it; nor
    is a fake one (a traced step's: it holds no values)."""
    if kv_len.shape != (B,) or kv_len.dtype != torch.int32:
        raise ValueError(f"kv_len: want an int32 tensor of shape ({B},), got "
                         f"{kv_len.dtype} {tuple(kv_len.shape)}")
    if (kv_len.device.type == "cpu" and not isinstance(kv_len, FakeTensor)
            and bool((kv_len < 1).any())):
        raise ValueError("kv_len: every row needs at least one valid key")


def _mask(S: int, T: int, causal: bool, window: int, device) -> torch.Tensor:
    """(S, T) bool: key t is visible from query row s (top-left causal)."""
    q_pos = torch.arange(S, device=device)[:, None]
    k_pos = torch.arange(T, device=device)[None, :]
    mask = torch.ones(S, T, dtype=torch.bool, device=device)
    if causal:
        mask &= k_pos <= q_pos
    if window > 0:
        mask &= k_pos > q_pos - window
    return mask


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int = 0,
                          kv_len: Optional[torch.Tensor] = None,
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q: (B, S, Hq, D); k/v: (B, T, Hkv, D) → (O (B, S, Hq, D), lse (B*Hq, S))."""
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    g = Hq // Hkv
    acc = _acc_dtype(q)
    qh = q.to(acc).reshape(B, S, Hkv, g, D)
    s = torch.einsum("bskgd,btkd->bkgst", qh, k.to(acc)) * (1.0 / math.sqrt(D))
    mask = _mask(S, T, causal, window, q.device).expand(B, S, T)
    k_pos = torch.arange(T, device=q.device)[None, :]
    if kv_len is not None:
        _check_kv_len(kv_len, B)
        mask = mask & (k_pos < kv_len.to(q.device).view(B, 1, 1))
    s = s.masked_fill(~mask[:, None, None], NEG_INF)
    lse = torch.logsumexp(s, dim=-1)                         # (B, Hkv, g, S)
    valid = mask.any(-1)[:, None, None, :]                   # (B, 1, 1, S)
    p = torch.exp(s - lse[..., None]) * valid[..., None]
    lse = lse.masked_fill(~valid, NEG_INF)
    o = torch.einsum("bkgst,btkd->bskgd", p, v.to(acc))
    return o.reshape(B, S, Hq, D).to(q.dtype), lse.reshape(B * Hq, S)


def _decode_plan(T: int, chunk: Optional[int] = None) -> Tuple[int, int]:
    """→ (chunk, splits) of the split-KV decode for a cache of T keys: split
    i takes keys [i·chunk, (i+1)·chunk), chunk ``DECODE_CHUNK`` unless
    given. From T alone: ``kv_len`` lies on the device and is not read here."""
    chunk = chunk or DECODE_CHUNK
    return chunk, max(1, -(-T // chunk))


def flash_decode_split_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             *, causal: bool = True, window: int = 0,
                             kv_len: Optional[torch.Tensor] = None,
                             chunk: Optional[int] = None,
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The split-KV decode's arithmetic in PyTorch, for the tests: per chunk
    of ``_decode_plan(T, chunk)`` each row's partial (max m, sum l and the
    unnormalised O of its valid keys; l = 0 and O = 0 for a chunk without
    one), then the kernel's merge: M = max of m over chunks with l > 0,
    L = Σ l·exp(m − M), O = Σ O_c·exp(m_c − M) / L, lse = M + log L (O = 0,
    lse = -1e30 where L = 0). Shapes and result as ``flash_attention_plain``."""
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    g = Hq // Hkv
    chunk, splits = _decode_plan(T, chunk)
    acc = _acc_dtype(q)
    mask = _mask(S, T, causal, window, q.device).expand(B, S, T)
    if kv_len is not None:
        _check_kv_len(kv_len, B)
        k_pos = torch.arange(T, device=q.device)[None, :]
        mask = mask & (k_pos < kv_len.to(q.device).view(B, 1, 1))
    pad = splits * chunk - T
    qh = q.to(acc).reshape(B, S, Hkv, g, D)
    kf, vf = (torch.nn.functional.pad(t.to(acc), (0, 0, 0, 0, 0, pad)) for t in (k, v))
    mask = torch.nn.functional.pad(mask, (0, pad)).view(B, 1, 1, S, splits, chunk)
    s = torch.einsum("bskgd,btkd->bkgst", qh, kf) * (1.0 / math.sqrt(D))
    s = s.view(B, Hkv, g, S, splits, chunk).masked_fill(~mask, NEG_INF)
    m = s.amax(-1)                                             # (B, Hkv, g, S, splits)
    p = torch.exp(s - m[..., None]) * mask
    l = p.sum(-1)
    o = torch.einsum("bkgsnc,bnckd->bkgsnd", p, vf.view(B, splits, chunk, Hkv, D))
    has = l > 0
    M = m.masked_fill(~has, NEG_INF).amax(-1, keepdim=True)
    w = torch.exp(m - M) * has
    L = (l * w).sum(-1)
    out = (o * w[..., None]).sum(-2) / torch.where(L > 0, L, torch.ones_like(L))[..., None]
    lse = torch.where(L > 0, M[..., 0] + torch.log(torch.where(L > 0, L, torch.ones_like(L))),
                      torch.full_like(L, NEG_INF))
    out = out.permute(0, 3, 1, 2, 4).reshape(B, S, Hq, D)
    return out.to(q.dtype), lse.reshape(B * Hq, S)


def _variant(q: torch.Tensor, k: torch.Tensor) -> str:
    """Which forward kernel a (checked) call takes: by dtype and shape."""
    S, Hq, Hkv = q.shape[1], q.shape[2], k.shape[2]
    if q.dtype == torch.float32:
        return "fma"
    if S <= DECODE_MAX_ROWS and (Hq // Hkv) * S <= DECODE_MAX_GROUP_ROWS:
        return "split_decode"
    return "tc_prefill"


def _check_aligned(caller: str, **tensors: torch.Tensor) -> None:
    """TMA and 16-byte cp.async need the base and every stride of a dim
    longer than 1 at a multiple of 16 bytes: raise, never copy quietly."""
    for name, t in tensors.items():
        size, shape, stride = t.element_size(), t.shape, t.stride()
        bad = t.data_ptr() % 16
        for i in range(3):
            if shape[i] > 1:
                bad |= stride[i] * size % 16
        if bad:
            raise ValueError(f"{caller}: {name} (shape {tuple(shape)}, strides "
                             f"{stride}) is not 16-byte aligned: the bf16 kernels need its "
                             f"base pointer and strides at multiples of 16 bytes")


_decode_counters: dict = {}


def _decode_counter(device: torch.device, n: int) -> torch.Tensor:
    """The split-KV kernel's per-(batch row, KV head) arrival counters on
    ``device``: zeroed once, and reset to 0 by the merging block of every
    launch, so launches on one stream reuse them."""
    buf = _decode_counters.get(device)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _decode_counters[device] = buf
    return buf


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0,
                         kv_len: Optional[torch.Tensor] = None,
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch one kernel of ``csrc/flash_fwd.cu`` on the current stream
    (``_variant``); counts each launch in ``flash_attention_cuda.launches``
    and by variant in ``flash_attention_cuda.variant_launches``. q, k, v may
    be strided views as long as their last dim is contiguous (e.g. a
    KV-cache slice); in bf16 they must be 16-byte aligned. A host ``kv_len``
    is checked (``>= 1``) and copied over; on a device one below 1 the
    kernel traps, and the launch fails."""
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
    variant = _variant(q, k)
    if variant != "fma":
        _check_aligned("flash_attention_cuda", q=q, k=k, v=v)
    lib = build.library()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            kv_len.data_ptr() if kv_len is not None else None, B, S, T, Hq, Hkv, D,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            int(causal), int(window), 1.0 / math.sqrt(D))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        if variant == "split_decode":
            chunk, splits = _decode_plan(T)
            rows = (Hq // Hkv) * S
            part = torch.empty(B * Hkv * splits * rows * (D + 2), dtype=torch.float32,
                               device=q.device)
            err = lib.repro_flash_decode_bf16(
                *args, stream, part.data_ptr(),
                _decode_counter(q.device, B * Hkv).data_ptr(), chunk, splits)
        elif variant == "tc_prefill":
            err = lib.repro_flash_fwd_bf16(*args, stream)
        else:
            err = lib.repro_flash_fwd_f32(*args, stream)
    build.check(err, f"flash_fwd ({variant})")
    flash_attention_cuda.launches += 1
    flash_attention_cuda.variant_launches[variant] += 1
    return o, lse


flash_attention_cuda.launches = 0
flash_attention_cuda.variant_launches = dict.fromkeys(VARIANTS, 0)


# ---------------------------------------------------------------------------
# backward
# ---------------------------------------------------------------------------
def _bwd_shapes(q, k, v, o, lse, do) -> Tuple[int, int, int, int, int, int]:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("flash_attention_bwd: want q (B,S,Hq,D), k/v (B,T,Hkv,D)")
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or Hkv == 0 or Hq % Hkv:
        raise ValueError(f"flash_attention_bwd: shapes {tuple(q.shape)} "
                         f"{tuple(k.shape)} do not match")
    if o.shape != q.shape or do.shape != q.shape or lse.shape != (B * Hq, S):
        raise ValueError(f"flash_attention_bwd: want o and do {tuple(q.shape)}, "
                         f"lse ({B * Hq}, {S}); got {tuple(o.shape)}, "
                         f"{tuple(do.shape)}, {tuple(lse.shape)}")
    return B, S, T, Hq, Hkv, D


def _delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """Δ = rowsum(dO∘O) in f32 (f64 for f64 inputs), laid out as lse (B*Hq, S)."""
    B, S, Hq, _ = o.shape
    acc = _acc_dtype(o)
    return (do.to(acc) * o.to(acc)).sum(-1).transpose(1, 2).reshape(B * Hq, S)


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                              *, causal: bool = True, window: int = 0,
                              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """→ (dq (B,S,Hq,D) in q's dtype, dk, dv (B,T,Hkv,D) in k's dtype).

    What JAX's ``flash_attention_bwd`` computes: p = exp(s·scale − lse)
    under the forward's mask (0 elsewhere), ds = p∘(dO·Vᵀ − Δ),
    dq = ds·K·scale, dk = dsᵀ·Q·scale, dv = pᵀ·dO, dk/dv summed over the GQA
    group; f32 inside (f64 for f64 inputs)."""
    B, S, T, Hq, Hkv, D = _bwd_shapes(q, k, v, o, lse, do)
    g, scale, acc = Hq // Hkv, 1.0 / math.sqrt(D), _acc_dtype(q)
    qh = q.to(acc).reshape(B, S, Hkv, g, D)
    doh = do.to(acc).reshape(B, S, Hkv, g, D)
    kf, vf = k.to(acc), v.to(acc)
    mask = _mask(S, T, causal, window, q.device)
    s = torch.einsum("bskgd,btkd->bkgst", qh, kf) * scale
    lse_h = lse.to(acc).reshape(B, Hkv, g, S, 1)
    p = torch.where(mask, torch.exp(s - lse_h), torch.zeros((), dtype=acc,
                                                            device=q.device))
    dp = torch.einsum("bskgd,btkd->bkgst", doh, vf)
    delta = _delta(o, do).reshape(B, Hkv, g, S, 1)
    ds = p * (dp - delta)
    dq = torch.einsum("bkgst,btkd->bskgd", ds, kf) * scale
    dk = torch.einsum("bkgst,bskgd->btkd", ds, qh) * scale
    dv = torch.einsum("bkgst,bskgd->btkd", p, doh)
    return dq.reshape(B, S, Hq, D).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _bwd_variant(q: torch.Tensor) -> str:
    """Which backward kernels a (checked) call takes: by dtype. bf16 takes
    the tensor-core kernels (TMA + ``wgmma``; P and dS rounded to bf16 as
    the A operand of dq += dS·K, dV += Pᵀ·dO and dK += dSᵀ·Q), f32 the FMA
    kernels."""
    return "tc" if q.dtype == torch.bfloat16 else "fma"


def _bwd_lib_call(name: str, variant: str):
    return getattr(build.library(),
                   f"repro_flash_bwd_{name}_{'bf16' if variant == 'tc' else 'f32'}")


def flash_bwd_dq_cuda(q, k, v, do, lse, delta, *, causal: bool, window: int
                      ) -> torch.Tensor:
    """Launch the dq kernel of ``_bwd_variant``; inputs as
    ``flash_attention_bwd_cuda`` has checked and laid them out. Counts each
    launch, and by variant in ``flash_bwd_dq_cuda.variant_launches``."""
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    variant = _bwd_variant(q)
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _bwd_lib_call("dq", variant)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), B, S, T, Hq, Hkv, D, int(causal),
            int(window), 1.0 / math.sqrt(D), stream)
    build.check(err, f"flash_bwd_dq ({variant})")
    flash_bwd_dq_cuda.launches += 1
    flash_bwd_dq_cuda.variant_launches[variant] += 1
    return dq


def flash_bwd_dkv_cuda(q, k, v, do, lse, delta, *, causal: bool, window: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the dk/dv kernel of ``_bwd_variant``; inputs as
    ``flash_attention_bwd_cuda`` has checked and laid them out. Counts each
    launch, and by variant in ``flash_bwd_dkv_cuda.variant_launches``."""
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    variant = _bwd_variant(q)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _bwd_lib_call("dkv", variant)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, S, T, Hq, Hkv, D,
            int(causal), int(window), 1.0 / math.sqrt(D), stream)
    build.check(err, f"flash_bwd_dkv ({variant})")
    flash_bwd_dkv_cuda.launches += 1
    flash_bwd_dkv_cuda.variant_launches[variant] += 1
    return dk, dv


for _fn in (flash_bwd_dq_cuda, flash_bwd_dkv_cuda):
    _fn.launches = 0
    _fn.variant_launches = dict.fromkeys(BWD_VARIANTS, 0)


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                             *, causal: bool = True, window: int = 0,
                             kv_len: Optional[torch.Tensor] = None,
                             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch ``csrc/flash_bwd.cu`` (dq, then dk/dv) on the current stream:
    the tensor-core kernels for bf16, the FMA ones for f32 (``_bwd_variant``).

    q, k, v, o and dO are made contiguous here (a no-op on the training
    path, where all five already are); Δ is a PyTorch reduction. ``kv_len``
    is refused: JAX's backward fixes ``kv_len = T``."""
    if kv_len is not None:
        raise ValueError("flash_attention_bwd_cuda: no kv_len in the backward "
                         "(every key below T is valid, as in JAX's)")
    B, S, T, Hq, Hkv, D = _bwd_shapes(q, k, v, o, lse, do)
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention_bwd_cuda: head dim {D} not in {HEAD_DIMS}")
    if q.dtype not in DTYPES or any(t.dtype != q.dtype for t in (k, v, o, do)):
        raise ValueError(f"flash_attention_bwd_cuda: dtypes {q.dtype}/{k.dtype}/"
                         f"{v.dtype}/{o.dtype}/{do.dtype}; want one of {DTYPES} for all")
    if lse.dtype != torch.float32:
        raise ValueError(f"flash_attention_bwd_cuda: lse must be f32, got {lse.dtype}")
    if not (q.is_cuda and all(t.device == q.device for t in (k, v, o, lse, do))):
        raise ValueError("flash_attention_bwd_cuda: all inputs must be on one CUDA device")
    q, k, v, o, do, lse = (t.contiguous() for t in (q, k, v, o, do, lse))
    if B == 0 or S == 0 or T == 0:
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    if _bwd_variant(q) == "tc":
        _check_aligned("flash_attention_bwd_cuda", q=q, k=k, v=v, do=do)
    delta = _delta(o, do).contiguous()
    dq = flash_bwd_dq_cuda(q, k, v, do, lse, delta, causal=causal, window=window)
    dk, dv = flash_bwd_dkv_cuda(q, k, v, do, lse, delta, causal=causal, window=window)
    return dq, dk, dv
