"""Mamba2 SSD chunked scan: the plain PyTorch version and the CUDA kernel's
wrapper.

The kernel (``csrc/ssd_scan.cu``) replaces the Pallas TPU kernel
``_ssd_kernel`` of ``src/repro/kernels/ssd_scan.py`` (wrapper
``ssd_scan_pallas``). Both versions here compute that kernel's function
(= ``repro.kernels.ref.ssd_scan_ref``, the sequential recurrence
``h_t = h_{t-1}·exp(dt_t·a) + dt_t·x_t⊗B_t``, ``y_t = C_t·h_t``) for
xh (B, S, H, P), dt (B, S, H), a (H,), B_/C_ (B, S, G, N), head h reading
group ``h // (H / G)``; inside in f32, y cast once to xh's dtype. Unlike the
TPU kernel they also return the final state (B, H, P, N) in f32: the state
a request's prefill leaves in its serving slot.

Any S is taken. The plain version pads the sequence to whole chunks with
dt = 0 (a padded row has dA = 0 and dt·x = 0: it neither decays nor feeds the
state), so y and the final state are exact; the kernel masks its own ragged
tile the same way. ``chunk`` is the plain version's chunk length; the kernel
tiles by 64 rows whatever it is (the SSD is exact under any chunking).

On the card the prefill is bound by bytes at mamba2-370m's shape
(B 4, S 1024, H 32, P 64, N 128: 12.0 µs of bytes, 10.9 µs of operations at
the config's chunk 256, counting only the causal half of the chunk's
products). The kernel's design notes are in its source.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from . import build

DTYPES = (torch.float32, torch.bfloat16)
STATE_DIMS = (16, 32, 64, 128)


def _shapes(xh, dt, a, B_, C_) -> Tuple[int, int, int, int, int, int]:
    if xh.dim() != 4 or B_.dim() != 4 or C_.shape != B_.shape:
        raise ValueError("ssd_scan: want xh (B,S,H,P), B_/C_ (B,S,G,N)")
    Bb, S, H, P = xh.shape
    G, N = B_.shape[2], B_.shape[3]
    if dt.shape != (Bb, S, H) or a.shape != (H,) or B_.shape[:2] != (Bb, S) \
            or G == 0 or H % G:
        raise ValueError(f"ssd_scan: shapes xh {tuple(xh.shape)}, dt {tuple(dt.shape)}, "
                         f"a {tuple(a.shape)}, B_/C_ {tuple(B_.shape)} do not match")
    return Bb, S, H, P, G, N


def ssd_scan_plain(xh: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                   B_: torch.Tensor, C_: torch.Tensor, chunk: int = 256,
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (y (B, S, H, P) in xh's dtype, h_final (B, H, P, N) in f32; f64
    for f64 inputs). ``repro.models.mamba2.ssd_chunked`` in f32: the
    intra-chunk dual form, the chunk states carried by the recurrence
    ``h ← h·exp(ΣdA) + S_c``, the incoming state's contribution."""
    Bb, S, H, P, G, N = _shapes(xh, dt, a, B_, C_)
    acc = torch.promote_types(xh.dtype, torch.float32)
    Q = max(1, chunk)
    nc = -(-S // Q)
    pad = nc * Q - S
    x, dtf, b, c = (t.to(acc) for t in (xh, dt, B_, C_))
    if pad:             # dt = 0 rows: no decay, no input
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dtf = F.pad(dtf, (0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, 0, 0, pad))
    R = H // G
    b = b.repeat_interleave(R, dim=2)                       # groups → heads
    c = c.repeat_interleave(R, dim=2)
    xc = (x * dtf[..., None]).reshape(Bb, nc, Q, H, P)     # discretised input
    bc = b.reshape(Bb, nc, Q, H, N)
    cc = c.reshape(Bb, nc, Q, H, N)
    dA = (dtf * a.to(acc)).reshape(Bb, nc, Q, H).permute(0, 3, 1, 2)   # (B,H,c,Q)
    cum = dA.cumsum(-1)
    tril = torch.ones(Q, Q, dtype=torch.bool, device=xh.device).tril()
    seg = (cum[..., :, None] - cum[..., None, :]).masked_fill(~tril, float("-inf"))
    decay = torch.exp(seg)                                  # (B,H,c,l,s)

    # intra-chunk (dual / attention-like form)
    cb = torch.einsum("bclhn,bcshn->bhcls", cc, bc)
    y = torch.einsum("bhcls,bcshp->bclhp", cb * decay, xc)

    # chunk summary states and the recurrence across chunks
    to_end = torch.exp(cum[..., -1:] - cum)                 # (B,H,c,Q)
    states = torch.einsum("bcshn,bhcs,bcshp->bchpn", bc, to_end, xc)
    chunk_decay = torch.exp(cum[..., -1])                   # (B,H,c)
    h = torch.zeros(Bb, H, P, N, dtype=acc, device=xh.device)
    h_in = []
    for ci in range(nc):
        h_in.append(h)
        h = h * chunk_decay[:, :, ci, None, None] + states[:, ci]

    # the incoming state's contribution
    y_off = torch.einsum("bclhn,bchpn->bclhp", cc, torch.stack(h_in, 1))
    y = y + y_off * torch.exp(cum).permute(0, 2, 3, 1)[..., None]
    return y.reshape(Bb, nc * Q, H, P)[:, :S].to(xh.dtype), h


def ssd_scan_cuda(xh: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                  B_: torch.Tensor, C_: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/ssd_scan.cu`` on the current stream; counts each launch
    in ``ssd_scan_cuda.launches``. xh, dt, B_ and C_ may be strided views
    (the splits of the model's xBC) as long as their last dim is contiguous.
    The kernel tiles by 64 rows, so it takes no chunk length."""
    Bb, S, H, P, G, N = _shapes(xh, dt, a, B_, C_)
    ts = (xh, dt, a, B_, C_)
    if xh.dtype not in DTYPES or any(t.dtype != xh.dtype for t in ts):
        raise ValueError(f"ssd_scan_cuda: dtypes {[str(t.dtype) for t in ts]}; want one "
                         f"of {DTYPES} for all")
    if not (xh.is_cuda and all(t.device == xh.device for t in ts)):
        raise ValueError("ssd_scan_cuda: all inputs must be on one CUDA device")
    if N not in STATE_DIMS or P % 32:
        raise ValueError(f"ssd_scan_cuda: state dim {N} not in {STATE_DIMS} or head dim "
                         f"{P} no multiple of 32")
    if xh.stride(-1) != 1 or B_.stride(-1) != 1 or C_.stride(-1) != 1:
        raise ValueError("ssd_scan_cuda: the last dim of xh, B_ and C_ must be contiguous")
    a = a.contiguous()
    y = torch.empty((Bb, S, H, P), dtype=xh.dtype, device=xh.device)
    h_final = torch.empty((Bb, H, P, N), dtype=torch.float32, device=xh.device)
    if Bb == 0 or S == 0 or H == 0:
        return y, h_final.zero_()
    lib = build.library()
    fn = lib.repro_ssd_scan_bf16 if xh.dtype == torch.bfloat16 else lib.repro_ssd_scan_f32
    with torch.cuda.device(xh.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(xh.data_ptr(), dt.data_ptr(), a.data_ptr(), B_.data_ptr(), C_.data_ptr(),
                 y.data_ptr(), h_final.data_ptr(), Bb, S, H, P, G, N,
                 *xh.stride()[:3], *dt.stride(), *B_.stride()[:3], *C_.stride()[:3],
                 stream)
    build.check(err, "ssd_scan")
    ssd_scan_cuda.launches += 1
    return y, h_final


ssd_scan_cuda.launches = 0
