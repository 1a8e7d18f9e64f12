"""Mixture-of-Experts FFN (port of ``repro.models.moe``): top-k router and
capacity-bounded dispatch.

Dispatch is gather/scatter based, as in ``repro``: each (token, choice)
gets its position within its expert from an exclusive cumsum of one-hots
in (t, k) order (``route``), its row of the experts' buffer by assignment
(``dispatch``), and the only products are the three expert GEMMs. Those go
through ``kernels.ops.moe_gmm``, the grouped GEMM that ``repro``'s Pallas
kernel ``_gmm_kernel`` computes (``ecd,edf->ecf``): the hand-written kernel
on the card, its plain version on the CPU.

On a device mesh the parameters are DTensors. Routing and dispatch run on
the whole (replicated) token set: the tokens are gathered first, so every
rank computes the same routing and buffer, as ``repro``'s global cumsum
does, and ``_constrain`` then keeps each rank's shard of the buffers
(``ep_mode``: expert-major, for expert-parallel serving; else
capacity-major). The grouped GEMM runs on each rank's shard
(``ops.moe_gmm``); its output is gathered for the combine, and the result
goes back to the tokens' placements. On plain tensors ``_constrain`` is the
identity.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Dict, Iterator, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate
from torch.distributed.tensor.experimental import local_map

from ..configs.base import MoEConfig
from ..kernels import ops
from ..shards import place, placements
from ..spans import no_span, span
from .layers import P, Schema

# up to this many tokens per call every expert holds every token (no drop)
NO_DROP_TOKENS = 256

# Expert-parallel mode (serve path): dispatch buffers shard expert-major to
# match EP weights, instead of capacity-major (the training layout). Set by
# the serve-step factory.
_EP_MODE: contextvars.ContextVar[bool] = contextvars.ContextVar("moe_ep_mode",
                                                               default=False)


@contextlib.contextmanager
def ep_mode() -> Iterator[None]:
    tok = _EP_MODE.set(True)
    try:
        yield
    finally:
        _EP_MODE.reset(tok)


def _drop_pod(a):
    if isinstance(a, tuple):
        t = tuple(x for x in a if x != "pod")
        return t if len(t) > 1 else (t[0] if t else None)
    return None if a == "pod" else a


def _constrain(x: torch.Tensor, *axes) -> torch.Tensor:
    """Redistribute a DTensor to the placements that ``axes`` (one entry per
    leading dim: a mesh-axis name, a tuple of them, or None) name on its
    mesh; where the mesh lacks an axis, retry with "pod" dropped, as
    ``repro``'s does, else leave x as it is. The identity on a plain tensor
    (no mesh)."""
    if not isinstance(x, DTensor):
        return x
    names = set(x.device_mesh.mesh_dim_names)
    for spec in (axes, tuple(_drop_pod(a) for a in axes)):
        named = {n for a in spec if a is not None
                 for n in ((a,) if isinstance(a, str) else a)}
        if named <= names:
            return place(x, placements(spec, x.device_mesh))
    return x


def moe_schema(d_model: int, moe: MoEConfig) -> Schema:
    ff, e = moe.d_ff_expert, moe.n_experts
    return {
        "router": P((d_model, e), ("embed", "experts")),
        "w_gate": P((e, d_model, ff), ("experts", "embed", "ff")),
        "w_up": P((e, d_model, ff), ("experts", "embed", "ff")),
        "w_down": P((e, ff, d_model), ("experts", "ff", "embed")),
    }


def capacity(T: int, moe: MoEConfig) -> int:
    """Slots per expert for T tokens: ``round(T·K/E·cf)`` (Python's round,
    halves to even, as ``repro``), at most T, and T when T <= 256 so that
    decode and small batches drop nothing."""
    if T <= NO_DROP_TOKENS:
        return T
    c = int(max(1, round(T * moe.top_k / moe.n_experts * moe.capacity_factor)))
    return min(c, T)


def route(xt: torch.Tensor, router: torch.Tensor, moe: MoEConfig):
    """xt (T, d) → (probs (T, E) f32, gate (T, K) f32 renormalised,
    expert_idx (T, K), pos (T·K,) position within the expert in (t, k)
    order, keep (T·K,) bool, capacity)."""
    T = xt.shape[0]
    E, K = moe.n_experts, moe.top_k
    logits = xt.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)
    gate, expert_idx = torch.topk(probs, K, dim=-1)
    gate = gate / gate.sum(-1, keepdim=True).clamp(min=1e-9)
    cap = capacity(T, moe)
    flat_e = expert_idx.reshape(T * K)
    # the one-hot laid out (E, T·K), so that the cumsum runs along contiguous
    # rows: down the columns of (T·K, E) the card scans each expert's
    # column with one thread, 32768 rows deep in a 4 x 1024 prefill
    onehot = (torch.arange(E, device=xt.device)[:, None] == flat_e[None, :]).long()
    pos_all = torch.cumsum(onehot, dim=1) - onehot                # exclusive
    pos = pos_all.gather(0, flat_e[None, :])[0]
    return probs, gate, expert_idx, pos, pos < cap, cap


def dispatch(xt: torch.Tensor, flat_e: torch.Tensor, pos: torch.Tensor,
             keep: torch.Tensor, E: int, cap: int) -> torch.Tensor:
    """The experts' input buffer (E, cap, d): token t's copy for choice k at
    (flat_e[t·K + k], pos[t·K + k]) where kept, zero in every empty slot.

    ``repro`` scatters with ``.at[].add``: a dropped (t, k) goes to (e, 0)
    with a zero contribution. Here the rows are assigned instead, into a
    flat (E·cap + 1, d) buffer whose last row takes every dropped (t, k)
    and is thrown away: the kept slots are unique (an exclusive cumsum), so
    no sum is needed, and on the card the assignment needs no sort (an
    accumulating ``index_put_`` sorts its indices). Each token's row is
    read through a broadcast view, never copied K times. The result equals
    ``repro``'s (0 + x = x)."""
    T, d = xt.shape
    K = flat_e.shape[0] // T
    row = torch.where(keep, flat_e * cap + pos, torch.full_like(pos, E * cap))
    flat = torch.zeros((E * cap + 1, d), dtype=xt.dtype, device=xt.device)
    flat[row.view(T, K)] = xt[:, None].expand(T, K, d)
    return flat[:E * cap].view(E, cap, d)


def _route_and_dispatch(xt: torch.Tensor, router: torch.Tensor, moe: MoEConfig):
    """xt (T, d) → (the experts' buffer (E, cap, d), flat_e (T·K,), pos_c
    (T·K,) each slot's row in its expert (0 where dropped), the combine
    weights w (T·K,) in xt's dtype, the aux loss f32)."""
    T = xt.shape[0]
    E, K = moe.n_experts, moe.top_k
    probs, gate, expert_idx, pos, keep, cap = route(xt, router, moe)
    # Switch load-balance loss from the first choice: E · Σ_e f_e · p̄_e
    assign1 = F.one_hot(expert_idx[:, 0], E).float()
    aux = E * (assign1.mean(0) * probs.mean(0)).sum()
    flat_e = expert_idx.reshape(T * K)
    buf = dispatch(xt, flat_e, pos, keep, E, cap)
    pos_c = torch.where(keep, pos, torch.zeros_like(pos))
    w = (gate.reshape(T * K) * keep).to(xt.dtype)
    return buf, flat_e, pos_c, w, aux


def _combine(out: torch.Tensor, flat_e: torch.Tensor, pos_c: torch.Tensor,
             w: torch.Tensor) -> torch.Tensor:
    """Each (token, choice) slot's expert output (E, C, d), weighted: →
    (T·K, d)."""
    return out[flat_e, pos_c] * w[:, None]


def moe_ffn(x: torch.Tensor, p: Dict[str, torch.Tensor], moe: MoEConfig,
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) → (y, aux_loss f32). Tokens past an expert's capacity
    contribute zero (they pass through residually), as in Switch/Mixtral."""
    B, S, d = x.shape
    K = moe.top_k
    T = B * S
    route_fn, combine_fn = _route_and_dispatch, _combine
    x_placements = x.placements if isinstance(x, DTensor) else None
    if x_placements is not None:
        mesh = x.device_mesh
        rep = (Replicate(),) * mesh.ndim
        # the token all-gather: routing and dispatch see every token, and
        # every rank computes the same buffer on its local copy
        x = place(x, rep)
        route_fn = local_map(_route_and_dispatch, out_placements=(list(rep),) * 5,
                             in_placements=(rep, rep, None), device_mesh=mesh)
        combine_fn = local_map(_combine, out_placements=list(rep),
                               in_placements=(rep, rep, rep, rep), device_mesh=mesh)
    # the stages' spans, in prefills and training only: in a decode step
    # (S = 1) they made a traced mixtral-8x22b round 2.9 % and 10.4 %
    # slower in two readings (PERF.md §6), more than tracing may cost
    stage = span if S > 1 else no_span
    with stage("moe.route"):        # routing, the balance loss, the dispatch
        buf, flat_e, pos_c, w, aux = route_fn(x.reshape(T, d), _to_replicated(p["router"]),
                                              moe)
    ep = _EP_MODE.get()
    # each rank's shard of the buffer: expert-major to meet EP weights,
    # else capacity-major (a local slice of the replicated buffer)
    buf = _constrain(buf, ("pod", "data"), None, None) if ep else \
        _constrain(buf, None, ("pod", "data"), None)

    with stage("moe.experts"):
        g = ops.moe_gmm(buf, p["w_gate"])
        u = ops.moe_gmm(buf, p["w_up"])
        out = ops.moe_gmm(F.silu(g) * u, p["w_down"])             # (E, C, d)
    with stage("moe.combine"):
        if isinstance(out, DTensor):
            # the expert outputs' all-gather (and the D partial sums' reduce)
            # for the combine, which reads every token's slots
            out = place(out, (Replicate(),) * out.device_mesh.ndim)
        y = combine_fn(out, flat_e, pos_c, w).reshape(T, K, d).sum(dim=1).reshape(B, S, d)
    if x_placements is not None:
        y = place(y, x_placements)                                # a local slice
    return y, aux


def _to_replicated(t: torch.Tensor) -> torch.Tensor:
    if isinstance(t, DTensor):
        return place(t, (Replicate(),) * t.device_mesh.ndim)
    return t
