"""Zamba2-style hybrid stack: Mamba2 backbone + one *shared* attention block
(port of ``repro.models.hybrid``).

The shared block's weights are applied every ``attn_every`` layers, the same
parameters each time; each application keeps its own K/V cache. The Mamba
layers keep ``repro``'s (groups, attn_every) stack, and a Python loop over
(group, index) takes the place of ``lax.scan``.

Two departures from ``repro``, both as the port's transformer has them. The
shared block's attention goes through ``ops.flash_attention`` (the
hand-written kernel on CUDA), where ``repro``'s hybrid calls XLA attention
even with Pallas on. And ``decode_step`` takes per-row positions (an int or
a (B,) tensor) and writes each row's K/V at its own position, where
``repro``'s takes one position for every row.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple, Union

import torch
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..kernels import ops
from ..shards import prefill_rows
from .layers import P, Schema, attention_schema, embed, mlp_schema, stack_schema, swiglu
from .mamba2 import (
    mamba_block,
    mamba_cache_shape,
    mamba_schema,
    prefill_layer,
    step_layer,
)
from .transformer import (
    REMAT,
    attend,
    attend_one,
    decode_slots,
    init_sharded_cache,
    maybe_seq_shard,
    on_shards,
    row_positions,
    seq_whole,
    to_residual,
    unembed,
    unstack,
)


def hybrid_groups(cfg: ModelConfig) -> Tuple[int, int]:
    """→ (groups, Mamba layers per group): the shared block follows each group."""
    assert cfg.hybrid is not None
    k = cfg.hybrid.attn_every
    assert cfg.n_layers % k == 0, (cfg.n_layers, k)
    return cfg.n_layers // k, k


def _shared(cfg: ModelConfig) -> bool:
    return cfg.hybrid is not None and cfg.hybrid.shared_attn


def hybrid_schema(cfg: ModelConfig) -> Schema:
    g, k = hybrid_groups(cfg)
    mamba = stack_schema(stack_schema(
        {"ln": P((cfg.d_model,), ("embed",), "ones"), **mamba_schema(cfg)},
        k, "pattern"), g, "layers")
    s: Schema = {
        "embed": {"table": P((cfg.vocab, cfg.d_model), ("vocab", "embed"))},
        "mamba": mamba,
        "final_norm": P((cfg.d_model,), ("embed",), "ones"),
        "lm_head": P((cfg.d_model, cfg.vocab), ("embed", "vocab")),
    }
    if _shared(cfg):
        s["shared"] = {
            "ln1": P((cfg.d_model,), ("embed",), "ones"),
            "attn": attention_schema(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                     cfg.head_dim_, cfg.qkv_bias),
            "ln2": P((cfg.d_model,), ("embed",), "ones"),
            "ffn": mlp_schema(cfg.d_model, cfg.d_ff),
        }
    return s


def _shared_attn_block(cfg: ModelConfig, p: Dict[str, Any], x: torch.Tensor,
                       positions: torch.Tensor,
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """→ (block output, roped K, V) for a full causal sequence."""
    o, k, v = attend(cfg, p["attn"], seq_whole(ops.rmsnorm(x, p["ln1"], cfg.norm_eps)),
                     positions)
    return _shared_ffn(cfg, p, x + to_residual(o, x)), k, v


def _shared_ffn(cfg: ModelConfig, p: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    h = seq_whole(ops.rmsnorm(x, p["ln2"], cfg.norm_eps))
    return x + to_residual(swiglu(h, p["ffn"]["w_gate"], p["ffn"]["w_up"], p["ffn"]["w_down"]),
                           x)


def forward(cfg: ModelConfig, params: Dict[str, Any], tokens: torch.Tensor,
            remat: str = "block") -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (logits (B, S, V), aux 0). With ``remat`` other than "none" each
    group (its Mamba layers and the shared block) runs under
    ``torch.utils.checkpoint`` where grad is on."""
    if remat not in REMAT:
        raise ValueError(f"remat={remat!r}: want one of {REMAT}")
    x = embed(params["embed"]["table"], tokens)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    g, k = hybrid_groups(cfg)
    layers = unstack(params["mamba"])
    shared = params.get("shared")

    def group_body(h: torch.Tensor, gi: int) -> torch.Tensor:
        h = maybe_seq_shard(h)
        for p in layers[gi]:
            y = mamba_block(seq_whole(ops.rmsnorm(h, p["ln"], cfg.norm_eps)), p, cfg)[0]
            h = h + to_residual(y, h)
        if shared is not None:
            h = _shared_attn_block(cfg, shared, h, positions)[0]
        return maybe_seq_shard(h)

    for gi in range(g):
        if remat != "none" and torch.is_grad_enabled():
            x = checkpoint(group_body, x, gi, use_reentrant=False)
        else:
            x = group_body(x, gi)
    x = ops.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return unembed(cfg, params, x), torch.zeros((), dtype=torch.float32, device=x.device)


# ---------------------------------------------------------------------------
# cache, decode, prefill
# ---------------------------------------------------------------------------
def cache_shapes(cfg: ModelConfig, batch: int, max_len: int) -> Dict[str, Tuple[int, ...]]:
    """repro's layout: "conv" (g, k, B, W-1, C), "ssm" (g, k, B, H, P, N),
    and with the shared block "attn_k"/"attn_v" (g, B, max_len, hkv, hd)."""
    g, k = hybrid_groups(cfg)
    ms = mamba_cache_shape(cfg, batch)
    shapes = {"conv": (g, k, *ms["conv"]), "ssm": (g, k, *ms["ssm"])}
    if _shared(cfg):
        for name in ("attn_k", "attn_v"):
            shapes[name] = (g, batch, max_len, cfg.n_kv_heads, cfg.head_dim_)
    return shapes


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16,
               device=None) -> Dict[str, torch.Tensor]:
    return {k: torch.zeros(s, dtype=dtype, device=device)
            for k, s in cache_shapes(cfg, batch, max_len).items()}


def decode_step(cfg: ModelConfig, params: Dict[str, Any], cache: Dict[str, torch.Tensor],
                token: torch.Tensor, pos: Union[int, torch.Tensor],
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step. token: (B,) int; pos: an int or a (B,) tensor of
    per-row positions (tokens already in that row's cache). Returns (logits
    (B, V), cache), the cache updated **in place**: each shared-block
    application writes row b's K/V and attends where
    ``transformer.decode_slots`` says for a full layer, at RoPE position
    ``pos[b]``."""
    pos_t = row_positions(pos, token.shape[0], token.device)
    x = embed(params["embed"]["table"], token)                 # (B, d)
    shared = params.get("shared")
    if shared is not None:
        at = decode_slots(pos_t, cache["attn_k"].shape[2])
    for gi, group in enumerate(unstack(params["mamba"])):
        for i, p in enumerate(group):
            x = step_layer(x, p, cache["conv"][gi, i], cache["ssm"][gi, i], cfg)
        if shared is None:
            continue
        o = attend_one(cfg, shared["attn"], ops.rmsnorm(x[:, None, :], shared["ln1"],
                                                        cfg.norm_eps),
                       pos_t[:, None], cache["attn_k"][gi], cache["attn_v"][gi], at)
        x = _shared_ffn(cfg, shared, x + o[:, 0])
    x = ops.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return unembed(cfg, params, x), cache


def prefill(cfg: ModelConfig, params: Dict[str, Any], tokens: torch.Tensor,
            max_len: int) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """→ (last-position logits (B, V), a fresh cache of ``max_len`` slots
    holding the prompt)."""
    table = params["embed"]["table"]
    if isinstance(tokens, DTensor):
        cache = init_sharded_cache(lambda b: cache_shapes(cfg, b, max_len), tokens,
                                   table.dtype)
    else:
        cache = init_cache(cfg, tokens.shape[0], max_len, table.dtype, table.device)
    return prefill_into(cfg, params, tokens, cache, 0), cache


def prefill_into(cfg: ModelConfig, params: Dict[str, Any], tokens: torch.Tensor,
                 cache: Dict[str, torch.Tensor], row: int = 0) -> torch.Tensor:
    """Prefill ``tokens`` (B, S) into rows ``row .. row + B - 1`` of ``cache``
    in place: every Mamba layer's conv tail and final state, every shared
    block application's K/V in slots 0..S-1 (the slots past the prompt
    zeroed). Returns the last-position logits (B, V)."""
    x = embed(params["embed"]["table"], tokens)
    B, S, _ = x.shape
    rows = prefill_rows(x, row)
    sharded = isinstance(x, DTensor)
    shared = params.get("shared")
    if shared is not None:
        if S > cache["attn_k"].shape[2]:
            raise ValueError(f"prompt of {S} tokens does not fit "
                             f"{cache['attn_k'].shape[2]} cache slots")
        for name in ("attn_k", "attn_v"):
            if sharded:
                on_shards(lambda c: c[:, :, S:].zero_(), cache[name])
            else:
                cache[name][:, rows, S:].zero_()
    positions = torch.arange(S, device=x.device)[None, :]
    for gi, group in enumerate(unstack(params["mamba"])):
        for i, p in enumerate(group):
            x = prefill_layer(x, p, cache["conv"][gi, i][rows], cache["ssm"][gi, i][rows],
                              cfg)
        if shared is not None:
            x, k, v = _shared_attn_block(cfg, shared, x, positions)
            if sharded:
                on_shards(lambda c, t: c[:, :S].copy_(t), cache["attn_k"][gi], k)
                on_shards(lambda c, t: c[:, :S].copy_(t), cache["attn_v"][gi], v)
            else:
                cache["attn_k"][gi, rows, :S] = k
                cache["attn_v"][gi, rows, :S] = v
    # the norm is row-wise: normalising the last position only is the same
    x = ops.rmsnorm(x[:, -1:, :].contiguous(), params["final_norm"], cfg.norm_eps)
    return unembed(cfg, params, x)[:, 0, :]
