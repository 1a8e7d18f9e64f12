"""The mixture-of-experts language model: pre-norm RMSNorm, RoPE,
grouped-query causal attention, a top-k softmax router renormalised over
its k choices with the Switch balance loss of the first choices, SwiGLU
experts, and the configuration's capacity rule: a call of T tokens up to
``no_drop_tokens`` drops nothing; above, each expert keeps the first
round(T·K/E·capacity_factor) choices (halves to even, at least 1, at most
T) in (token, choice) order. Its reference layer is plain PyTorch."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..arch import Arch
from ..reference.model import Prec, attention, rmsnorm, rope


@dataclass(frozen=True)
class MoEArch(Arch):
    n_experts: int
    top_k: int
    d_expert: int
    capacity_factor: float
    no_drop_tokens: int
    aux_weight: float


def arch(c: Dict[str, Any], common: Dict[str, Any]) -> MoEArch:
    return MoEArch(
        **common, n_experts=c.get("num_experts") or c["num_local_experts"],
        top_k=c["num_experts_per_tok"],
        d_expert=c.get("moe_intermediate_size") or c["intermediate_size"],
        capacity_factor=float(c["capacity_factor"]), no_drop_tokens=int(c["no_drop_tokens"]),
        aux_weight=float(c["router_aux_loss_coef"]))


def mismatches(a: MoEArch, p: Any) -> Dict[str, Tuple[Any, Any]]:
    moe = p.moe
    return {
        "experts": (a.n_experts, moe.n_experts if moe else None),
        "num_experts_per_tok": (a.top_k, moe.top_k if moe else None),
        "expert intermediate_size": (a.d_expert, moe.d_ff_expert if moe else None),
        "capacity_factor": (a.capacity_factor, moe.capacity_factor if moe else None),
    }


def program_config(a: MoEArch, p: Any) -> Any:
    """The balance loss's weight as the file states it."""
    return p.scaled(moe=dataclasses.replace(p.moe, aux_loss_weight=a.aux_weight))


def leaves(a: MoEArch) -> List[Tuple[str, Tuple[int, ...], bool]]:
    """(name, shape of one layer's leaf, whether it is per layer) of every
    leaf, named by the program's key paths."""
    d, hd = a.d, a.head_dim
    per_layer = [
        ("blocks/ln1", (d,)), ("blocks/ln2", (d,)),
        ("blocks/attn/wq", (d, a.n_heads * hd)), ("blocks/attn/wk", (d, a.n_kv_heads * hd)),
        ("blocks/attn/wv", (d, a.n_kv_heads * hd)), ("blocks/attn/wo", (a.n_heads * hd, d)),
        ("blocks/ffn/router", (d, a.n_experts)),
        ("blocks/ffn/w_gate", (a.n_experts, d, a.d_expert)),
        ("blocks/ffn/w_up", (a.n_experts, d, a.d_expert)),
        ("blocks/ffn/w_down", (a.n_experts, a.d_expert, d)),
    ]
    return ([("embed/table", (a.vocab, d), False), ("final_norm", (d,), False),
             ("lm_head", (d, a.vocab), False)]
            + [(n, s, True) for n, s in per_layer])


def matmul_params(a: MoEArch) -> int:
    """Parameters that take part in a token's products: attention's four
    projections, the router and K experts of every layer, and the output
    head (the embedding is a lookup)."""
    hd = a.head_dim
    attn = a.d * a.n_heads * hd + 2 * a.d * a.n_kv_heads * hd + a.n_heads * hd * a.d
    per_layer = attn + a.d * a.n_experts + a.top_k * 3 * a.d * a.d_expert
    return a.n_layers * per_layer + a.d * a.vocab


def capacity(T: int, a: MoEArch) -> int:
    """Slots per expert for a call of T tokens (the rule above)."""
    if T <= a.no_drop_tokens:
        return T
    return min(T, int(max(1, round(T * a.top_k / a.n_experts * a.capacity_factor))))


def route(x: torch.Tensor, router: torch.Tensor, a: MoEArch, cap: int, prec: Prec):
    """x (T, d) → (expert (T, K), gate (T, K) renormalised, kept (T, K),
    aux): choice k of token t keeps its slot if fewer than ``cap`` choices
    before it, in (t, k) order, went to the same expert. aux is the Switch
    balance loss of the first choices, E · Σ_e f_e · mean p_e."""
    T, K, E = x.shape[0], a.top_k, a.n_experts
    probs = torch.softmax(prec.mm(x, router), dim=-1)
    gate, expert = torch.topk(probs, K, dim=-1)
    gate = gate / gate.sum(-1, keepdim=True).clamp(min=1e-9)
    flat = expert.reshape(-1)
    onehot = F.one_hot(flat, E)
    before = (torch.cumsum(onehot, dim=0) - onehot).gather(1, flat[:, None])[:, 0]
    kept = (before < cap).reshape(T, K)
    f = F.one_hot(expert[:, 0], E).float().mean(0)
    aux = E * (f * probs.mean(0)).sum()
    return expert, gate, kept, aux


def experts(x: torch.Tensor, w: Dict[str, torch.Tensor], expert: torch.Tensor,
            gate: torch.Tensor, kept: torch.Tensor, prec: Prec) -> torch.Tensor:
    """Σ over each token's kept choices of gate · SwiGLU expert(x), expert
    by expert."""
    y = torch.zeros_like(x)
    K = expert.shape[1]
    for e in range(w["blocks/ffn/w_gate"].shape[0]):
        sel = ((expert == e) & kept).reshape(-1).nonzero()[:, 0]
        if sel.numel() == 0:
            continue
        tok = sel // K
        h = x[tok]
        z = F.silu(prec.mm(h, w["blocks/ffn/w_gate"][e])) * prec.mm(h, w["blocks/ffn/w_up"][e])
        out = prec.mm(z, w["blocks/ffn/w_down"][e]) * gate.reshape(-1)[sel][:, None]
        y = y.index_add(0, tok, out)
    return y


def block(x: torch.Tensor, w: Dict[str, torch.Tensor], a: MoEArch, positions: torch.Tensor,
          calls: Sequence[Tuple[int, int, bool]], prec: Prec,
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One layer on x (1, S, d): → (x out, the layer's term of the loss:
    the balance loss's weight times its sum over the calls that may drop).
    ``calls`` lists (start, end, drops): the tokens each MoE call of the
    program routed together; a call that drops has the capacity
    ``capacity(end - start)``, one that does not holds every choice (the
    decode rounds, whose calls never drop)."""
    B, S, _ = x.shape
    h = rmsnorm(x, w["blocks/ln1"], a.eps)
    hd = a.head_dim
    q = prec.mm(h, w["blocks/attn/wq"]).view(B, S, a.n_heads, hd)
    k = prec.mm(h, w["blocks/attn/wk"]).view(B, S, a.n_kv_heads, hd)
    v = prec.mm(h, w["blocks/attn/wv"]).view(B, S, a.n_kv_heads, hd)
    q, k = rope(q, positions, a.rope_theta), rope(k, positions, a.rope_theta)
    o = attention(q, k, v, a.window).reshape(B, S, a.n_heads * hd)
    x = x + prec.mm(o, w["blocks/attn/wo"])
    h = rmsnorm(x, w["blocks/ln2"], a.eps)[0]
    parts: List[torch.Tensor] = []
    aux = torch.zeros((), device=x.device)
    for s0, s1, drops in calls:
        hs = h[s0:s1]
        cap = capacity(s1 - s0, a) if drops else s1 - s0
        expert, gate, kept, aux_s = route(hs, w["blocks/ffn/router"], a, cap, prec)
        parts.append(experts(hs, w, expert, gate, kept, prec))
        if drops:
            aux = aux + aux_s
    return x + torch.cat(parts)[None], a.aux_weight * aux
