"""Mixture-of-Experts FFN (port of ``repro.models.moe``): top-k router and
capacity-bounded dispatch.

Dispatch is gather/scatter based, as in ``repro``: each (token, choice)
gets its position within its expert from an exclusive cumsum of one-hots
in (t, k) order (``route``), its row of the experts' buffer by assignment
(``dispatch``), and the only products are the three expert GEMMs. Those go
through ``kernels.ops.moe_gmm``, the grouped GEMM that ``repro``'s Pallas
kernel ``_gmm_kernel`` computes (``ecd,edf->ecf``): the hand-written kernel
on the card, its plain version on the CPU.

``repro``'s ``_constrain`` and ``ep_mode`` only place the dispatch buffers'
shards on a mesh; on one GPU they are the identity and have no counterpart.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import MoEConfig
from ..kernels import ops
from .layers import P, Schema

# up to this many tokens per call every expert holds every token (no drop)
NO_DROP_TOKENS = 256


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


def moe_ffn(x: torch.Tensor, p: Dict[str, torch.Tensor], moe: MoEConfig,
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) → (y, aux_loss f32). Tokens past an expert's capacity
    contribute zero (they pass through residually), as in Switch/Mixtral."""
    B, S, d = x.shape
    E, K = moe.n_experts, moe.top_k
    T = B * S
    xt = x.reshape(T, d)
    probs, gate, expert_idx, pos, keep, cap = route(xt, p["router"], moe)

    # Switch load-balance loss from the first choice: E · Σ_e f_e · p̄_e
    assign1 = F.one_hot(expert_idx[:, 0], E).float()
    aux = E * (assign1.mean(0) * probs.mean(0)).sum()

    flat_e = expert_idx.reshape(T * K)
    buf = dispatch(xt, flat_e, pos, keep, E, cap)
    pos_c = torch.where(keep, pos, torch.zeros_like(pos))

    g = ops.moe_gmm(buf, p["w_gate"])
    u = ops.moe_gmm(buf, p["w_up"])
    out = ops.moe_gmm(F.silu(g) * u, p["w_down"])                 # (E, C, d)

    y_slots = out[flat_e, pos_c]                                  # (T·K, d)
    w = (gate.reshape(T * K) * keep).to(x.dtype)
    y = (y_slots * w[:, None]).reshape(T, K, d).sum(dim=1)
    return y.reshape(B, S, d), aux
