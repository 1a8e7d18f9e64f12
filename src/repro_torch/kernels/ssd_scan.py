"""Mamba2 SSD chunked scan: the plain PyTorch versions and the CUDA kernels'
wrapper.

The kernels (``csrc/ssd_scan.cu``) replace the Pallas TPU kernel
``_ssd_kernel`` of ``src/repro/kernels/ssd_scan.py`` (wrapper
``ssd_scan_pallas``). Every version here computes that kernel's function
(= ``repro.kernels.ref.ssd_scan_ref``, the sequential recurrence
``h_t = h_{t-1}·exp(dt_t·a) + dt_t·x_t⊗B_t``, ``y_t = C_t·h_t``) for
xh (B, S, H, P), dt (B, S, H), a (H,), B_/C_ (B, S, G, N), head h reading
group ``h // (H / G)``; inside in f32, y cast once to xh's dtype. Unlike the
TPU kernel they also return the final state (B, H, P, N) in f32: the state
a request's prefill leaves in its serving slot.

Any S is taken. The plain version pads the sequence to whole chunks with
dt = 0 (a padded row has dA = 0 and dt·x = 0: it neither decays nor feeds the
state), so y and the final state are exact; the kernels mask their own
ragged chunk the same way. ``chunk`` is the plain version's chunk length;
the SSD is exact under any chunking, so the kernels keep their own.

``ssd_scan_cuda`` takes one of two kernels by dtype (``_variant``), a
documented choice and never a fallback from a kernel that failed:

- ``tc`` (bf16, every N in ``STATE_DIMS`` and P a multiple of 32): chunks of
  ``TC_CHUNK`` rows in parallel across the card, the state passed from
  chunk to chunk inside the launch; C·Bᵀ once per block for the
  ``_heads_per_block`` heads of one group it takes, M·x and C·h_in on
  ``wgmma``, the chunk state on ``mma.sync`` with w∘x split into bf16
  hi + lo. M and h_in (for y) are rounded to bf16; the carried state is
  f32. ``ssd_scan_tc_plain`` is its arithmetic in PyTorch, for the tests.
  It reads xh, B_ and C_ through TMA: each base pointer and each stride of
  a dim longer than 1 must be a multiple of 16 bytes, or the wrapper
  raises.
- ``fma`` (f32): one block per (batch, head, P tile) walking the sequence
  in tiles of 64 rows, f32 FMAs.

On the card the prefill is bound by bytes at mamba2-370m's shape
(B 4, S 1024, H 32, P 64, N 128: 12.0 µs of bytes, ~5.5 µs of operations
with C·Bᵀ shared by the group). The kernels' design notes are in their
source.

The backward (the TPU kernel has none: JAX differentiates ``ssd_chunked``
with XLA) is ``ssd_scan_bwd_cuda`` (``csrc/ssd_scan_bwd.cu``), given dy and
the final state's gradient, by dtype (``_bwd_variant``):

- ``tc`` (bf16): three launches. The chunk-local terms of both recurrences
  (the state S_c and the gradient's G_c) per 128-row chunk in parallel; the
  recurrences themselves over the chunks, elementwise, into each chunk's
  h_in and outgoing-state gradient g in bf16; then every chunk's gradients
  in parallel, the products on ``wgmma``, a block taking
  ``_bwd_heads_per_block`` heads of one group and adding dB and dC once
  for all of them. ``ssd_scan_bwd_tc_plain`` is its arithmetic in PyTorch.
  xh, B_, C_ and dy must be 16-byte aligned, as the forward's.
- ``fma`` (f32): one block per (batch, head, P tile) that recomputes each
  64-row tile's incoming state, then walks the tiles in reverse carrying
  dL/dh, f32 FMAs.

dB and dC (summed over a group's heads), ddt (over the P tiles) and da
(over batch and sequence) are summed in f32 across blocks, in no fixed
order. Each kernel's arithmetic is ``ssd_scan_bwd_plain``'s up to
summation order and, for ``tc``, its bf16 roundings.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import build
from .flash_attention import _check_aligned

DTYPES = (torch.float32, torch.bfloat16)
STATE_DIMS = (16, 32, 64, 128)
VARIANTS = ("tc", "fma")
BWD_VARIANTS = ("tc", "fma")
BWD_TILE = 64        # rows of a tile of the backward's fma kernel
TC_CHUNK = 128        # rows of a chunk of the tc kernel: two warpgroups of 64
TC_MAX_HEADS = 8      # heads a tc block takes at most (one warp scans each)
# a tc block takes as many heads of its group as keeps at least this many
# blocks per SM in the launch: more heads share C·Bᵀ and overlap one head's
# x load with another's work, fewer blocks leave SMs waiting on a block's
# loads (``kernel_times --ssd-heads`` times the choices)
TC_MIN_BLOCKS_PER_SM = 3
TC_BWD_MAX_HEADS = 4  # heads a tc backward block takes at most
# a tc backward block takes as many heads of its group as keeps at least
# this many blocks per SM (one block fills an SM): more heads add dB and
# dC to device memory fewer times (``kernel_times --ssd-heads`` times the
# choices)
TC_BWD_MIN_BLOCKS_PER_SM = 1


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


def ssd_scan_tc_plain(xh: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                      B_: torch.Tensor, C_: torch.Tensor, chunk: int = TC_CHUNK,
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``tc`` kernel's arithmetic in PyTorch, for the tests (nothing on
    the card's path calls it): chunks of ``chunk`` rows; C·Bᵀ once per
    (batch, group, chunk) in f32; M = (C·Bᵀ)∘exp(cum_i − cum_j)·dt_j for
    j <= i, rounded to bf16 for bf16 inputs; y = M·x in f32; the chunk state
    (w∘x)ᵀ·B, w_j = exp(cum_last − cum_j)·dt_j, from w∘x split into bf16 hi
    + lo for bf16 inputs; h carried in f32, and rounded to bf16 for y's
    exp(cum_i)·C_i·h_in term. f32 inputs round nothing (f64 compute in
    f64). → (y in xh's dtype, h_final (B, H, P, N) f32; f64 for f64)."""
    Bb, S, H, P, G, N = _shapes(xh, dt, a, B_, C_)
    acc = torch.promote_types(xh.dtype, torch.float32)
    low = xh.dtype == torch.bfloat16

    def rnd(t: torch.Tensor) -> torch.Tensor:
        return t.to(torch.bfloat16).to(acc) if low else t

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
    x = x.reshape(Bb, nc, Q, H, P)
    b = b.reshape(Bb, nc, Q, G, N)
    c = c.reshape(Bb, nc, Q, G, N)
    cb = torch.einsum("bclgn,bcsgn->bgcls", c, b).repeat_interleave(R, dim=1)
    dth = dtf.reshape(Bb, nc, Q, H).permute(0, 3, 1, 2)             # (B,H,c,Q)
    cum = (dth * a.to(acc)[None, :, None, None]).cumsum(-1)
    tril = torch.ones(Q, Q, dtype=torch.bool, device=xh.device).tril()
    decay = torch.exp((cum[..., :, None] - cum[..., None, :]).masked_fill(~tril, float("-inf")))
    m = rnd(cb * decay * dth[..., None, :])                          # (B,H,c,l,s)
    y = torch.einsum("bhcls,bcshp->bclhp", m, x)

    w = torch.exp(cum[..., -1:] - cum) * dth                         # (B,H,c,Q)
    wx = x.permute(0, 3, 1, 2, 4) * w[..., None]                     # (B,H,c,Q,P)
    bh = b.repeat_interleave(R, dim=3)                               # (B,c,Q,H,N)
    if low:
        hi = rnd(wx)
        parts = (hi, rnd(wx - hi))
    else:
        parts = (wx,)
    states = sum(torch.einsum("bhcsp,bcshn->bhcpn", part, bh) for part in parts)
    chunk_decay = torch.exp(cum[..., -1])                            # (B,H,c)
    h = torch.zeros(Bb, H, P, N, dtype=acc, device=xh.device)
    h_in = []
    for ci in range(nc):
        h_in.append(rnd(h))
        h = h * chunk_decay[:, :, ci, None, None] + states[:, :, ci]
    ch = c.repeat_interleave(R, dim=3)                               # (B,c,Q,H,N)
    y_off = torch.einsum("bclhn,bhcpn->bclhp", ch, torch.stack(h_in, 2))
    y = y + y_off * torch.exp(cum).permute(0, 2, 3, 1)[..., None]
    return y.reshape(Bb, nc * Q, H, P)[:, :S].to(xh.dtype), h


def ssd_scan_bwd_plain(xh: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                       B_: torch.Tensor, C_: torch.Tensor, dy: torch.Tensor,
                       dh_final: Optional[torch.Tensor] = None, chunk: int = BWD_TILE,
                       ) -> Tuple[torch.Tensor, ...]:
    """The gradients of ``ssd_scan_plain``'s (y, h_final) for dy (B, S, H, P)
    and dh_final (B, H, P, N; None is zero): → (dxh, ddt, da, dB, dC), each
    in its input's dtype, computed in f32 (f64 for f64 inputs) with one
    cast each; dB and dC sum over the H/G heads of a group, da over batch
    and sequence. The explicit backward of the chunked form, in chunks of
    ``chunk`` rows (the kernel's tile; exact under any chunking): within a
    chunk, with L_ij = exp(cum_i − cum_j) for j <= i, M = (C·Bᵀ)∘L·dt_j,
    W = (dy·xᵀ)∘L·dt_j, T' = (C·Bᵀ)∘L∘(dy·xᵀ), w_j = exp(cum_Q − cum_j)·dt_j
    and g the gradient of the chunk's outgoing state:
    dx = Mᵀ·dy + w∘(B·gᵀ), dC = W·B + exp(cum)∘(dy·h_in),
    dB = Wᵀ·C + w∘(x·g), g ← exp(cum_Q)·g + (exp(cum)∘dy)ᵀ·C; ddt and da
    through cum by suffix sums (``csrc/ssd_scan_bwd.cu`` derives them).
    Only exponents of arguments <= 0 are taken."""
    Bb, S, H, P, G, N = _shapes(xh, dt, a, B_, C_)
    if dy.shape != xh.shape or (dh_final is not None and dh_final.shape != (Bb, H, P, N)):
        raise ValueError(f"ssd_scan_bwd: dy {tuple(dy.shape)} / dh_final "
                         f"{None if dh_final is None else tuple(dh_final.shape)} do not "
                         f"match xh {tuple(xh.shape)}")
    acc = torch.promote_types(xh.dtype, torch.float32)
    Q = max(1, chunk)
    nc = -(-S // Q)
    pad = nc * Q - S
    x, dtf, b, c, g_y = (t.to(acc) for t in (xh, dt, B_, C_, dy))
    af = a.to(acc)
    if pad:             # dt = 0 rows: no decay, no input, no gradient
        x, g_y = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (x, g_y))
        dtf = F.pad(dtf, (0, 0, 0, pad))
        b, c = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (b, c))
    R = H // G
    x = x.reshape(Bb, nc, Q, H, P)
    g_y = g_y.reshape(Bb, nc, Q, H, P)
    bh = b.repeat_interleave(R, dim=2).reshape(Bb, nc, Q, H, N)
    ch = c.repeat_interleave(R, dim=2).reshape(Bb, nc, Q, H, N)
    dtc = dtf.reshape(Bb, nc, Q, H)
    cum = (dtc * af).cumsum(2)                                       # (B,c,Q,H)
    ecum = torch.exp(cum)
    wq = torch.exp(cum[:, :, -1:] - cum)
    w = wq * dtc
    decay = torch.exp(cum[:, :, -1])                                 # (B,c,H)

    # each chunk's incoming state, by the forward recurrence
    states = torch.einsum("bcqhp,bcqhn->bchpn", x * w[..., None], bh)
    h = torch.zeros(Bb, H, P, N, dtype=acc, device=xh.device)
    h_in = []
    for ci in range(nc):
        h_in.append(h)
        h = h * decay[:, ci, :, None, None] + states[:, ci]
    h_in = torch.stack(h_in, 1)                                      # (B,c,H,P,N)
    # each chunk's outgoing-state gradient, in reverse
    g = torch.zeros_like(h) if dh_final is None else dh_final.to(acc)
    g_out = [None] * nc
    for ci in range(nc - 1, -1, -1):
        g_out[ci] = g
        g = g * decay[:, ci, :, None, None] + torch.einsum(
            "bqhp,bqhn->bhpn", g_y[:, ci] * ecum[:, ci, :, :, None], ch[:, ci])
    g_out = torch.stack(g_out, 1)                                    # (B,c,H,P,N)

    # the chunk's (i, j) matrices, (B, c, H, i, j)
    cumt = cum.transpose(2, 3)                                       # (B,c,H,Q)
    dtt = dtc.transpose(2, 3)
    tril = torch.ones(Q, Q, dtype=torch.bool, device=xh.device).tril()
    lm = torch.exp((cumt[..., :, None] - cumt[..., None, :]).masked_fill(~tril, float("-inf")))
    cb = torch.einsum("bcihn,bcjhn->bchij", ch, bh)
    dyx = torch.einsum("bcihp,bcjhp->bchij", g_y, x)
    m = cb * lm * dtt[..., None, :]
    wmat = dyx * lm * dtt[..., None, :]
    tp = cb * lm * dyx

    bg = torch.einsum("bcjhn,bchpn->bcjhp", bh, g_out)
    dxh = torch.einsum("bchij,bcihp->bcjhp", m, g_y) + w[..., None] * bg
    u = (x * bg).sum(-1)                                             # (B,c,Q,H)
    dyh = torch.einsum("bcihp,bchpn->bcihn", g_y, h_in)
    dch = torch.einsum("bchij,bcjhn->bcihn", wmat, bh) + ecum[..., None] * dyh
    dbh = torch.einsum("bchij,bcihn->bcjhn", wmat, ch) + \
        w[..., None] * torch.einsum("bcjhp,bchpn->bcjhn", x, g_out)

    # dcum, then ddA by suffix sums within each chunk
    row = (tp * dtt[..., None, :]).sum(-1).transpose(2, 3)           # (B,c,Q,H)
    col = tp.sum(-2).transpose(2, 3)
    dcum = row - dtc * col + (ch * ecum[..., None] * dyh).sum(-1) - w * u
    dcum[:, :, -1] += decay * (g_out * h_in).sum((-1, -2)) + (w * u).sum(2)
    dda = dcum.flip(2).cumsum(2).flip(2)
    ddt = col + wq * u + af * dda
    da = (dtc * dda).sum((0, 1, 2))

    def unchunk(t, last):
        return t.reshape(Bb, nc * Q, *last)[:, :S]

    dB = unchunk(dbh, (G, R, N)).sum(3)
    dC = unchunk(dch, (G, R, N)).sum(3)
    return (unchunk(dxh, (H, P)).to(xh.dtype), unchunk(ddt, (H,)).to(dt.dtype),
            da.to(a.dtype), dB.to(B_.dtype), dC.to(C_.dtype))


def ssd_scan_bwd_tc_plain(xh: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                          B_: torch.Tensor, C_: torch.Tensor, dy: torch.Tensor,
                          dh_final: Optional[torch.Tensor] = None, chunk: int = TC_CHUNK,
                          ) -> Tuple[torch.Tensor, ...]:
    """The ``tc`` backward kernels' arithmetic in PyTorch, for the tests
    (nothing on the card's path calls it): ``ssd_scan_bwd_plain``'s
    function in chunks of ``chunk`` rows, rounded where the kernels round
    for bf16 inputs. The chunk states S_c = (w∘x)ᵀ·B and G_c = (e^{cum}∘dy)ᵀ·C
    from bf16 hi + lo splits of w∘x and e^{cum}∘dy, stored in bf16; h_in and
    the outgoing gradient g carried over the chunks in f32, rounded to bf16
    where they enter a product (and <g, h_in>); M' = (C·Bᵀ)∘L and W = (dy·xᵀ)∘L·dt_j
    (L_ij = e^{cum_i − cum_j}, j <= i) rounded to bf16, but W's diagonal,
    which the kernel adds back in f32 (the rounding residual r_j times C_j
    into dB, times B_j into dC: where a row's dB or dC is that one term, as
    at S = 1, the heads' W_jj can cancel and leave only their roundings);
    dt∘x, wq∘(dt∘x) and e^{cum}∘dy rounded to bf16. T' = M'∘(dy·xᵀ) enters only through its
    sums: by columns x_j·(M'ᵀ·dy)_j, by rows with dt_j dy_i·(M'·(dt∘x))_i
    (part of dy·y, y the forward's output); the scalar chain in f32. f32
    inputs round nothing (f64 compute in f64). → (dxh, ddt, da, dB, dC) in
    the inputs' dtypes."""
    Bb, S, H, P, G, N = _shapes(xh, dt, a, B_, C_)
    if dy.shape != xh.shape or (dh_final is not None and dh_final.shape != (Bb, H, P, N)):
        raise ValueError(f"ssd_scan_bwd: dy {tuple(dy.shape)} / dh_final "
                         f"{None if dh_final is None else tuple(dh_final.shape)} do not "
                         f"match xh {tuple(xh.shape)}")
    acc = torch.promote_types(xh.dtype, torch.float32)
    low = xh.dtype == torch.bfloat16

    def rnd(t: torch.Tensor) -> torch.Tensor:
        return t.to(torch.bfloat16).to(acc) if low else t

    def split(t: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        if not low:
            return (t,)
        hi = rnd(t)
        return hi, rnd(t - hi)

    Q = max(1, chunk)
    nc = -(-S // Q)
    pad = nc * Q - S
    x, dtf, b, c, g_y = (t.to(acc) for t in (xh, dt, B_, C_, dy))
    af = a.to(acc)
    if pad:             # dt = 0 rows: no decay, no input, no gradient
        x, g_y = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (x, g_y))
        dtf = F.pad(dtf, (0, 0, 0, pad))
        b, c = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (b, c))
    R = H // G
    x = x.reshape(Bb, nc, Q, H, P)
    g_y = g_y.reshape(Bb, nc, Q, H, P)
    b = b.reshape(Bb, nc, Q, G, N)
    c = c.reshape(Bb, nc, Q, G, N)
    bh = b.repeat_interleave(R, dim=3)                               # (B,c,Q,H,N)
    ch = c.repeat_interleave(R, dim=3)
    dtc = dtf.reshape(Bb, nc, Q, H)
    cum = (dtc * af).cumsum(2)                                       # (B,c,Q,H)
    ecum = torch.exp(cum)
    wq = torch.exp(cum[:, :, -1:] - cum)
    w = wq * dtc
    decay = torch.exp(cum[:, :, -1])                                 # (B,c,H)

    # the chunk states, then both recurrences over the chunks
    wx = x * w[..., None]
    ey = g_y * ecum[..., None]
    s_c = rnd(sum(torch.einsum("bcqhp,bcqhn->bchpn", part, bh) for part in split(wx)))
    g_c = rnd(sum(torch.einsum("bcqhp,bcqhn->bchpn", part, ch) for part in split(ey)))
    h = torch.zeros(Bb, H, P, N, dtype=acc, device=xh.device)
    h_in = []
    for ci in range(nc):
        h_in.append(rnd(h))
        h = h * decay[:, ci, :, None, None] + s_c[:, ci]
    g = torch.zeros_like(h) if dh_final is None else dh_final.to(acc)
    g_out = [None] * nc
    for ci in range(nc - 1, -1, -1):
        g_out[ci] = rnd(g)
        g = g * decay[:, ci, :, None, None] + g_c[:, ci]
    h_in = torch.stack(h_in, 1)                                      # (B,c,H,P,N)
    g_out = torch.stack(g_out, 1)

    # the chunk's (i, j) matrices, (B, c, H, i, j): M' = (C·Bᵀ)∘L, W = (dy·xᵀ)∘L·dt_j
    cumt = cum.transpose(2, 3)                                       # (B,c,H,Q)
    dtt = dtc.transpose(2, 3)
    tril = torch.ones(Q, Q, dtype=torch.bool, device=xh.device).tril()
    lm = torch.exp((cumt[..., :, None] - cumt[..., None, :]).masked_fill(~tril, float("-inf")))
    cb = torch.einsum("bcign,bcjgn->bcgij", c, b).repeat_interleave(R, dim=2)
    mp = rnd(cb * lm)
    w32 = torch.einsum("bcihp,bcjhp->bchij", g_y, x) * lm * dtt[..., None, :]
    wmat = torch.where(torch.eye(Q, dtype=torch.bool, device=xh.device), w32, rnd(w32))

    # rows j: dx, dB; the column sums of T' = M'∘(dy·xᵀ) as x·(M'ᵀ·dy)
    mdy = torch.einsum("bchij,bcihp->bcjhp", mp, g_y)
    bg = torch.einsum("bcjhn,bchpn->bcjhp", bh, g_out)
    dxh = dtc[..., None] * mdy + w[..., None] * bg
    col = (x * mdy).sum(-1)                                          # (B,c,Q,H)
    u = (x * bg).sum(-1)
    xdt = rnd(x * dtc[..., None])
    dbh = torch.einsum("bchij,bcihn->bcjhn", wmat, ch) + \
        torch.einsum("bcjhp,bchpn->bcjhn", rnd(xdt * wq[..., None]), g_out)
    # rows i: dC; dy·y with y the forward's output (its rows' sums of T'·dt
    # and the incoming state's term)
    dch = torch.einsum("bchij,bcjhn->bcihn", wmat, bh) + \
        torch.einsum("bcihp,bchpn->bcihn", rnd(ey), h_in)
    y = torch.einsum("bchij,bcjhp->bcihp", mp, xdt) + \
        ecum[..., None] * torch.einsum("bcihn,bchpn->bcihp", ch, h_in)
    dyy = (g_y * y).sum(-1)

    # dcum's term dt_j·Col_j from the same rounded dt∘x as y's: the two
    # cancel over the chunk (sum_k dt_k Col_k = sum_k of y's M' part)
    dcum = dyy - (xdt * mdy).sum(-1) - w * u
    dcum[:, :, -1] += decay * (g_out * h_in).sum((-1, -2)) + (w * u).sum(2)
    dda = dcum.flip(2).cumsum(2).flip(2)
    ddt = col + wq * u + af * dda
    da = (dtc * dda).sum((0, 1, 2))

    def unchunk(t, last):
        return t.reshape(Bb, nc * Q, *last)[:, :S]

    dB = unchunk(dbh, (G, R, N)).sum(3)
    dC = unchunk(dch, (G, R, N)).sum(3)
    return (unchunk(dxh, (H, P)).to(xh.dtype), unchunk(ddt, (H,)).to(dt.dtype),
            da.to(a.dtype), dB.to(B_.dtype), dC.to(C_.dtype))


def _variant(dtype: torch.dtype, N: int, P: int) -> str:
    """Which kernel a call takes: ``tc`` for bf16, ``fma`` for f32, at every
    state dim in ``STATE_DIMS`` and head dim that is a multiple of 32;
    another shape raises."""
    if N not in STATE_DIMS or P % 32:
        raise ValueError(f"ssd_scan_cuda: state dim {N} not in {STATE_DIMS} or head dim "
                         f"{P} no multiple of 32")
    return "tc" if dtype == torch.bfloat16 else "fma"


def _p_tile(P: int) -> int:
    """Columns of P a tc block takes."""
    return 64 if P % 64 == 0 else 32


def _heads_per_block(B: int, S: int, H: int, G: int, P: int, sms: int) -> int:
    """The heads a tc block takes: the most (a divisor of H/G, at most
    ``TC_MAX_HEADS``) that leave the launch ``TC_MIN_BLOCKS_PER_SM`` blocks
    an SM, else 1. Each block computes its chunk's C·Bᵀ once for them."""
    units = B * -(-S // TC_CHUNK) * (P // _p_tile(P))
    best = 1
    for d in range(2, TC_MAX_HEADS + 1):
        if (H // G) % d == 0 and units * (H // d) >= TC_MIN_BLOCKS_PER_SM * sms:
            best = d
    return best


_sync_buffers: dict = {}


def _sync_buffer(device: torch.device, n: int) -> torch.Tensor:
    """The tc kernel's ticket, finish count and per-(b, h, P tile) chunk
    flags on ``device``: zeroed once, and left at 0 by every launch, so
    launches on one stream reuse them."""
    buf = _sync_buffers.get(device)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        _sync_buffers[device] = buf
    return buf


def ssd_scan_cuda(xh: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                  B_: torch.Tensor, C_: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch one kernel of ``csrc/ssd_scan.cu`` on the current stream
    (``_variant``); counts each launch in ``ssd_scan_cuda.launches`` and by
    variant in ``ssd_scan_cuda.variant_launches``. xh, dt, B_ and C_ may be
    strided views (the splits of the model's xBC) as long as their last dim
    is contiguous; in bf16 xh, B_ and C_ must be 16-byte aligned. The
    kernels keep their own chunking, so this takes no chunk length."""
    Bb, S, H, P, G, N = _shapes(xh, dt, a, B_, C_)
    ts = (xh, dt, a, B_, C_)
    if xh.dtype not in DTYPES or any(t.dtype != xh.dtype for t in ts):
        raise ValueError(f"ssd_scan_cuda: dtypes {[str(t.dtype) for t in ts]}; want one "
                         f"of {DTYPES} for all")
    if not (xh.is_cuda and all(t.device == xh.device for t in ts)):
        raise ValueError("ssd_scan_cuda: all inputs must be on one CUDA device")
    variant = _variant(xh.dtype, N, P)
    if xh.stride(-1) != 1 or B_.stride(-1) != 1 or C_.stride(-1) != 1:
        raise ValueError("ssd_scan_cuda: the last dim of xh, B_ and C_ must be contiguous")
    a = a.contiguous()
    y = torch.empty((Bb, S, H, P), dtype=xh.dtype, device=xh.device)
    h_final = torch.empty((Bb, H, P, N), dtype=torch.float32, device=xh.device)
    if Bb == 0 or S == 0 or H == 0:
        return y, h_final.zero_()
    if variant == "tc":
        _check_aligned("ssd_scan_cuda", xh=xh, B_=B_, C_=C_)
    lib = build.library()
    args = (xh.data_ptr(), dt.data_ptr(), a.data_ptr(), B_.data_ptr(), C_.data_ptr(),
            y.data_ptr(), h_final.data_ptr(), Bb, S, H, P, G, N,
            *xh.stride()[:3], *dt.stride(), *B_.stride()[:3], *C_.stride()[:3])
    with torch.cuda.device(xh.device):
        stream = torch.cuda.current_stream().cuda_stream
        if variant == "tc":
            sync = _sync_buffer(xh.device, 2 + Bb * H * (P // _p_tile(P)))
            sms = torch.cuda.get_device_properties(xh.device).multi_processor_count
            heads = _heads_per_block(Bb, S, H, G, P, sms)
            err = lib.repro_ssd_scan_bf16(*args, stream, sync.data_ptr(), heads)
        else:
            err = lib.repro_ssd_scan_f32(*args, stream)
    build.check(err, f"ssd_scan ({variant})")
    ssd_scan_cuda.launches += 1
    ssd_scan_cuda.variant_launches[variant] += 1
    return y, h_final


ssd_scan_cuda.launches = 0
ssd_scan_cuda.variant_launches = dict.fromkeys(VARIANTS, 0)


def _bwd_variant(dtype: torch.dtype, N: int, P: int) -> str:
    """Which backward kernel a call takes: ``tc`` for bf16, ``fma`` for f32,
    at the shapes the forward takes; another dtype or shape raises."""
    _variant(dtype, N, P)
    if dtype not in DTYPES:
        raise ValueError(f"ssd_scan_bwd_cuda: dtype {dtype}; want one of {DTYPES}")
    return "tc" if dtype == torch.bfloat16 else "fma"


def _bwd_heads_per_block(B: int, S: int, H: int, G: int, P: int, sms: int) -> int:
    """The heads a tc backward block takes: the most (a divisor of H/G, at
    most ``TC_BWD_MAX_HEADS``) that leave the launch
    ``TC_BWD_MIN_BLOCKS_PER_SM`` blocks an SM, else 1."""
    units = B * -(-S // TC_CHUNK) * (P // _p_tile(P))
    best = 1
    for d in range(2, TC_BWD_MAX_HEADS + 1):
        if (H // G) % d == 0 and units * (H // d) >= TC_BWD_MIN_BLOCKS_PER_SM * sms:
            best = d
    return best


def ssd_scan_bwd_cuda(xh: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                      B_: torch.Tensor, C_: torch.Tensor, dy: torch.Tensor,
                      dh_final: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, ...]:
    """Launch the backward kernel of ``csrc/ssd_scan_bwd.cu`` that
    ``_bwd_variant`` names on the current stream: → (dxh, ddt, da, dB, dC)
    in the inputs' dtypes, as ``ssd_scan_bwd_plain``. Takes the forward's
    inputs as ``ssd_scan_cuda`` does (strided views with a contiguous last
    dim; bf16 xh, B_, C_ and dy 16-byte aligned), dy likewise, dh_final (B,
    H, P, N) f32 or None (zero: training reads no final state, and that
    costs nothing). Counts each call in ``ssd_scan_bwd_cuda.launches`` and
    by variant in ``ssd_scan_bwd_cuda.variant_launches``."""
    Bb, S, H, P, G, N = _shapes(xh, dt, a, B_, C_)
    ts = (xh, dt, a, B_, C_, dy)
    if xh.dtype not in DTYPES or any(t.dtype != xh.dtype for t in ts):
        raise ValueError(f"ssd_scan_bwd_cuda: dtypes {[str(t.dtype) for t in ts]}; want "
                         f"one of {DTYPES} for all")
    if dy.shape != xh.shape or (dh_final is not None and (
            dh_final.shape != (Bb, H, P, N) or dh_final.dtype != torch.float32)):
        raise ValueError("ssd_scan_bwd_cuda: want dy shaped as xh and dh_final "
                         "(B, H, P, N) f32 or None")
    if not (xh.is_cuda and all(t.device == xh.device for t in ts)
            and (dh_final is None or dh_final.device == xh.device)):
        raise ValueError("ssd_scan_bwd_cuda: all inputs must be on one CUDA device")
    variant = _bwd_variant(xh.dtype, N, P)
    if any(t.stride(-1) != 1 for t in (xh, B_, C_, dy)):
        raise ValueError("ssd_scan_bwd_cuda: the last dim of xh, B_, C_ and dy must be "
                         "contiguous")
    if variant == "tc":
        _check_aligned("ssd_scan_bwd_cuda", xh=xh, B_=B_, C_=C_, dy=dy)
    dev, f32 = xh.device, torch.float32
    dxh = torch.empty((Bb, S, H, P), dtype=xh.dtype, device=dev)
    # dB, dC, ddt and da are summed across blocks in f32: one zeroed buffer
    # (dB and dC first, their rows 16-byte aligned for the bulk adds), cast
    # once to the inputs' dtype. Few tensor ops: on the host-bound train
    # step each costs as much as a small kernel.
    nbc, nddt = Bb * S * G * N, Bb * S * H
    acc = torch.zeros(2 * nbc + nddt + H, dtype=f32, device=dev)
    if Bb and S and H:
        a = a.contiguous()
        dh = None if dh_final is None else dh_final.contiguous()
        lib = build.library()
        at = acc.data_ptr()
        args = (xh.data_ptr(), dt.data_ptr(), a.data_ptr(), B_.data_ptr(), C_.data_ptr(),
                dy.data_ptr(), None if dh is None else dh.data_ptr(), dxh.data_ptr(),
                at + 4 * 2 * nbc, at + 4 * (2 * nbc + nddt), at, at + 4 * nbc)
        strides = (*xh.stride()[:3], *dt.stride(), *B_.stride()[:3], *C_.stride()[:3],
                   *dy.stride()[:3])
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            if variant == "tc":
                # scratch: per chunk S_c, G_c, h_in and g in bf16, then cum_last f32
                nc = -(-S // TC_CHUNK)
                n = Bb * H * nc * P * N
                scratch = torch.empty(4 * 2 * n + 4 * Bb * H * nc, dtype=torch.uint8, device=dev)
                sp = scratch.data_ptr()
                heads = _bwd_heads_per_block(Bb, S, H, G, P, _sm_count(dev))
                err = lib.repro_ssd_scan_bwd_bf16(
                    *args, sp, sp + 2 * n, sp + 8 * n, sp + 4 * n, sp + 6 * n,
                    Bb, S, H, P, G, N, *strides, stream, heads)
            else:
                hbuf = torch.empty((Bb, H, -(-S // BWD_TILE), P, N), dtype=f32, device=dev)
                err = lib.repro_ssd_scan_bwd_f32(*args, hbuf.data_ptr(), Bb, S, H, P, G, N,
                                                 *strides, stream)
        build.check(err, f"ssd_scan_bwd ({variant})")
        ssd_scan_bwd_cuda.launches += 1
        ssd_scan_bwd_cuda.variant_launches[variant] += 1
    dB, dC, ddt, da = acc.to(xh.dtype).split((nbc, nbc, nddt, H))
    return dxh, ddt.view(Bb, S, H), da, dB.view(Bb, S, G, N), dC.view(Bb, S, G, N)


_sm_counts: dict = {}


def _sm_count(device: torch.device) -> int:
    """The card's SM count, read once a device."""
    if device not in _sm_counts:
        _sm_counts[device] = torch.cuda.get_device_properties(device).multi_processor_count
    return _sm_counts[device]


ssd_scan_bwd_cuda.launches = 0
ssd_scan_bwd_cuda.variant_launches = dict.fromkeys(BWD_VARIANTS, 0)
