"""Decoder-only transformer stack, dense, MoE and VLM families (port of
``repro.models.transformer``).

Parameters keep ``repro``'s scan-stacked layout: every block leaf carries a
leading (groups, pattern_len) stack, and a Python loop over (group, pattern
index) takes the place of ``lax.scan``. Architectures with a repeating
layer pattern (gemma3's local:global) unroll the pattern inside each group.

KV caches are per-kind: "full" layers cache all positions; "window" and
"local" (sliding-window) layers keep a ring buffer of window slots. Norms,
attention and the MoE expert products go through ``kernels.ops``
(hand-written kernels on CUDA, their plain versions on CPU; norms and
attention differentiable where the inputs require grad); the other large
products stay ``torch.matmul``.

A VLM prepends its image: ``vision_proj`` maps the stub frontend's patch
embeddings to the model width, and those rows come before the tokens'
(``embed_inputs``). ``forward`` returns logits over the token positions
only; ``prefill`` caches the patch rows and the prompt, so decoding goes
on at position ``n_patches + S``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple, Union

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..kernels import ops
from .layers import (
    P,
    Schema,
    apply_rope,
    attention_schema,
    mlp_schema,
    qkv_project,
    stack_schema,
    swiglu,
)
from .moe import moe_ffn, moe_schema

REMAT = ("none", "block", "full")


# ---------------------------------------------------------------------------
# layer pattern
# ---------------------------------------------------------------------------
def layer_pattern(cfg: ModelConfig) -> List[str]:
    if cfg.local_global > 0:
        return ["local"] * cfg.local_global + ["full"]
    if cfg.window > 0:
        return ["window"]
    return ["full"]


def n_groups(cfg: ModelConfig) -> int:
    pat = layer_pattern(cfg)
    assert cfg.n_layers % len(pat) == 0, (cfg.n_layers, pat)
    return cfg.n_layers // len(pat)


def _window_of(cfg: ModelConfig, kind: str) -> int:
    if kind == "local":
        return cfg.local_window
    if kind == "window":
        return cfg.window
    return 0


def _kind_slots(pat: List[str]) -> List[Tuple[str, int]]:
    """(kind, index among the pattern's layers of that kind) per position."""
    seen: Dict[str, int] = {}
    out = []
    for k in pat:
        out.append((k, seen.get(k, 0)))
        seen[k] = seen.get(k, 0) + 1
    return out


# ---------------------------------------------------------------------------
# schema
# ---------------------------------------------------------------------------
def block_schema(cfg: ModelConfig) -> Schema:
    return {
        "ln1": P((cfg.d_model,), ("embed",), "ones"),
        "attn": attention_schema(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                 cfg.head_dim_, cfg.qkv_bias),
        "ln2": P((cfg.d_model,), ("embed",), "ones"),
        "ffn": (moe_schema(cfg.d_model, cfg.moe) if cfg.family == "moe"
                else mlp_schema(cfg.d_model, cfg.d_ff)),
    }


def lm_schema(cfg: ModelConfig) -> Schema:
    pat = layer_pattern(cfg)
    g = n_groups(cfg)
    blocks = stack_schema(stack_schema(block_schema(cfg), len(pat), "pattern"),
                          g, "layers")
    s: Schema = {
        "embed": {"table": P((cfg.vocab, cfg.d_model), ("vocab", "embed"))},
        "blocks": blocks,
        "final_norm": P((cfg.d_model,), ("embed",), "ones"),
    }
    if not cfg.tie_embeddings:
        s["lm_head"] = P((cfg.d_model, cfg.vocab), ("embed", "vocab"))
    if cfg.vision is not None:
        s["vision_proj"] = P((cfg.vision.patch_dim, cfg.d_model), (None, "embed"))
    return s


def unstack(tree: Any, depth: int = 2) -> List[Any]:
    """Views of each layer's params in a stack of ``depth`` leading dims
    ([group][pattern index] for 2, [layer] for 1), by one ``unbind`` per
    stack dim. Its backward stacks the layers' gradients once; indexing each
    layer out (``v[gi, i]``) would give each layer's gradient a zero-filled
    stack of its own for autograd to sum, L full-size adds per leaf."""
    if not isinstance(tree, dict):
        return [t if depth == 1 else unstack(t, depth - 1) for t in tree.unbind(0)]
    return _zip({k: unstack(v, depth) for k, v in tree.items()}, depth)


def _zip(parts: Dict[str, List[Any]], depth: int) -> List[Any]:
    """{key: nested lists} → nested lists of {key: leaf}."""
    n = len(next(iter(parts.values())))
    rows = [{k: p[i] for k, p in parts.items()} for i in range(n)]
    return rows if depth == 1 else [_zip(r, depth - 1) for r in rows]


# ---------------------------------------------------------------------------
# forward (prefill): full-sequence causal
# ---------------------------------------------------------------------------
def _ffn(cfg: ModelConfig, p: Dict[str, Any], h: torch.Tensor,
         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The block's FFN: → (y, the MoE aux loss, or None for a dense FFN)."""
    if cfg.family == "moe":
        return moe_ffn(h, p, cfg.moe)
    return swiglu(h, p["w_gate"], p["w_up"], p["w_down"]), None


def _roped_qkv(cfg: ModelConfig, p: Dict[str, Any], h: torch.Tensor,
               positions: torch.Tensor,
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    q, k, v = qkv_project(h, p, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_)
    q = apply_rope(q, positions, fraction=cfg.rope_fraction, theta=cfg.rope_theta)
    k = apply_rope(k, positions, fraction=cfg.rope_fraction, theta=cfg.rope_theta)
    return q, k, v


def attend(cfg: ModelConfig, p: Dict[str, Any], h: torch.Tensor, positions: torch.Tensor,
           window: int = 0) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Causal attention over a full sequence: normed input h (B, S, d) →
    (output projection (B, S, d), roped K, V)."""
    q, k, v = _roped_qkv(cfg, p, h, positions)
    o = ops.flash_attention(q, k, v, causal=True, window=window)
    B, S = h.shape[:2]
    return o.reshape(B, S, -1) @ p["wo"], k, v


def decode_slots(pos_t: torch.Tensor, slots: int, window: int = 0,
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Where a decode step at per-row positions ``pos_t`` (B,) writes and
    reads a cache of ``slots`` slots: → (rows, write slot, kv_len). Row b
    writes at ``pos[b] % slots`` in a window layer's ring and at ``pos[b]``
    in a full layer, clamped to the last slot as ``dynamic_update_slice``
    does in ``repro``; it attends to ``min(pos[b] + 1, slots)`` slots."""
    write = pos_t % slots if window > 0 else pos_t.clamp(max=slots - 1)
    return (torch.arange(pos_t.shape[0], device=pos_t.device), write,
            (pos_t + 1).clamp(max=slots).to(torch.int32))


def attend_one(cfg: ModelConfig, p: Dict[str, Any], h: torch.Tensor,
               positions: torch.Tensor, kc: torch.Tensor, vc: torch.Tensor,
               at: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """A decode step's attention: normed input h (B, 1, d) at RoPE positions
    (B, 1) → output projection (B, 1, d). Each row's K/V go into its cache
    rows kc/vc (B, slots, hkv, hd) in place, where ``at`` (``decode_slots``)
    says, and it attends to its first kv_len slots."""
    q, k, v = _roped_qkv(cfg, p, h, positions)
    rows, write, kv_len = at
    kc[rows, write] = k[:, 0]
    vc[rows, write] = v[:, 0]
    o, _ = ops.flash_attention_fwd(q, kc, vc, causal=False, window=0, kv_len=kv_len)
    return o.reshape(h.shape[0], 1, -1) @ p["wo"]


def _block(cfg: ModelConfig, p: Dict[str, Any], x: torch.Tensor,
           positions: torch.Tensor, kind: str,
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """→ (block output, roped K, V, MoE aux or None) for a full causal
    sequence."""
    o, k, v = attend(cfg, p["attn"], ops.rmsnorm(x, p["ln1"], cfg.norm_eps), positions,
                     _window_of(cfg, kind))
    x = x + o
    y, aux = _ffn(cfg, p["ffn"], ops.rmsnorm(x, p["ln2"], cfg.norm_eps))
    return x + y, k, v, aux


def embed_inputs(cfg: ModelConfig, params: Dict[str, Any], tokens: torch.Tensor,
                 patches: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token embeddings (B, S, d); a VLM's patches (B, n_patches, patch_dim),
    cast to the table's dtype and projected by ``vision_proj``, come before
    them: (B, n_patches + S, d)."""
    x = params["embed"]["table"][tokens]
    if n_patches(cfg, patches):
        x = torch.cat([patches.to(x.dtype) @ params["vision_proj"], x], dim=1)
    return x


def n_patches(cfg: ModelConfig, patches: Optional[torch.Tensor]) -> int:
    """The patch rows that ``patches`` put before the tokens: 0 without
    patches; patches given to a model with no vision config raise."""
    if patches is None:
        return 0
    if cfg.vision is None:
        raise ValueError(f"{cfg.name} has no vision config: it takes no patches")
    return cfg.vision.n_patches


def forward(cfg: ModelConfig, params: Dict[str, Any], tokens: torch.Tensor,
            patches: Optional[torch.Tensor] = None, remat: str = "block",
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (logits (B, S, V) over the token positions, aux_loss: the layers'
    MoE aux losses summed, 0 for a dense model). A VLM's ``patches`` run
    through the layers ahead of the tokens (``embed_inputs``) and their
    rows are dropped before the unembed. ``remat`` other than "none" keeps no
    activation of a layer group for the backward pass: each group's body
    runs under ``torch.utils.checkpoint`` and is recomputed there, as
    ``jax.checkpoint(group_body, policy=nothing_saveable)`` does in
    ``repro`` ("block" and "full" are the same there too). The final norm
    and the unembed stay outside the groups."""
    if remat not in REMAT:
        raise ValueError(f"remat={remat!r}: want one of {REMAT}")
    x = embed_inputs(cfg, params, tokens, patches)
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)[None, :]
    pat = layer_pattern(cfg)
    layers = unstack(params["blocks"])

    def group_body(h: torch.Tensor, aux: torch.Tensor, gi: int,
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        for i, kind in enumerate(pat):
            h, _, _, a = _block(cfg, layers[gi][i], h, positions, kind)
            if a is not None:
                aux = aux + a
        return h, aux

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for gi in range(n_groups(cfg)):
        if remat != "none" and torch.is_grad_enabled():
            x, aux = checkpoint(group_body, x, aux, gi, use_reentrant=False)
        else:
            x, aux = group_body(x, aux, gi)
    x = ops.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    x = x[:, n_patches(cfg, patches):]                 # the text positions
    return unembed(cfg, params, x), aux


def unembed(cfg: ModelConfig, params: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        return x @ params["embed"]["table"].T
    return x @ params["lm_head"]


# ---------------------------------------------------------------------------
# KV cache + decode
# ---------------------------------------------------------------------------
def cache_shapes(cfg: ModelConfig, batch: int, max_len: int) -> Dict[str, Any]:
    """Ring-buffered window slots for local layers; full slots otherwise."""
    pat = layer_pattern(cfg)
    g = n_groups(cfg)
    hd, hkv = cfg.head_dim_, cfg.n_kv_heads
    shapes: Dict[str, Any] = {}
    for kind in ("full", "window", "local"):
        cnt = sum(1 for k in pat if k == kind)
        if cnt == 0:
            continue
        w = _window_of(cfg, kind)
        slots = max_len if w == 0 else min(w, max_len)
        shapes[kind] = {
            "k": (g, cnt, batch, slots, hkv, hd),
            "v": (g, cnt, batch, slots, hkv, hd),
        }
    return shapes


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> Dict[str, Any]:
    return {kind: {name: torch.zeros(shape, dtype=dtype, device=device)
                   for name, shape in d.items()}
            for kind, d in cache_shapes(cfg, batch, max_len).items()}


def row_positions(pos: Union[int, torch.Tensor], B: int, device) -> torch.Tensor:
    """An int or a (B,) int tensor of per-row positions → (B,) int64 on
    ``device``; a host tensor is checked for positions below 0."""
    pos_t = torch.as_tensor(pos, dtype=torch.int64)
    if pos_t.dim() == 0:
        pos_t = pos_t.expand(B)
    if pos_t.shape != (B,):
        raise ValueError(f"pos: want an int or shape ({B},), got {tuple(pos_t.shape)}")
    if pos_t.device.type == "cpu" and bool((pos_t < 0).any()):
        raise ValueError("pos: positions must be >= 0")
    return pos_t.to(device)


def decode_step(cfg: ModelConfig, params: Dict[str, Any],
                cache: Dict[str, Any], token: torch.Tensor,
                pos: Union[int, torch.Tensor],
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decode step. token: (B,) int; pos: an int, or a (B,) int tensor of
    per-row positions (number of tokens already in that row's cache).
    Returns (logits (B, V), cache).

    The cache is updated **in place** and returned: each row writes its new
    K/V and attends where ``decode_slots`` says, at its own RoPE position.
    With all positions equal this is ``repro``'s scalar-pos step.
    """
    pos_t = row_positions(pos, token.shape[0], token.device)
    at = {knd: decode_slots(pos_t, d["k"].shape[3], _window_of(cfg, knd))
          for knd, d in cache.items()}

    x = params["embed"]["table"][token][:, None, :]            # (B, 1, d)
    positions = pos_t[:, None]
    pat = layer_pattern(cfg)
    kind_of = _kind_slots(pat)
    layers = unstack(params["blocks"])
    for gi in range(n_groups(cfg)):
        for i in range(len(pat)):
            p = layers[gi][i]
            knd, slot = kind_of[i]
            x = x + attend_one(cfg, p["attn"], ops.rmsnorm(x, p["ln1"], cfg.norm_eps),
                               positions, cache[knd]["k"][gi, slot],
                               cache[knd]["v"][gi, slot], at[knd])
            y, _ = _ffn(cfg, p["ffn"], ops.rmsnorm(x, p["ln2"], cfg.norm_eps))
            x = x + y
    x = ops.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return unembed(cfg, params, x)[:, 0, :], cache


def prefill(cfg: ModelConfig, params: Dict[str, Any], tokens: torch.Tensor,
            max_len: int, patches: Optional[torch.Tensor] = None,
            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Run the full prompt (a VLM's patch rows first) through the causal
    kernel path, build a cache of size max_len, return (last-position
    logits (B, V), cache). With patches the cache holds ``n_patches + S``
    positions, and decoding goes on at position ``n_patches + S``."""
    B, S = tokens.shape
    n = n_patches(cfg, patches)
    if n + S > max_len:
        raise ValueError(f"prompt of {n} patches and {S} tokens does not fit "
                         f"max_len={max_len}")
    table = params["embed"]["table"]
    cache = init_cache(cfg, B, max_len, table.dtype, table.device)
    return prefill_into(cfg, params, tokens, cache, 0, patches), cache


def prefill_into(cfg: ModelConfig, params: Dict[str, Any], tokens: torch.Tensor,
                 cache: Dict[str, Any], row: int = 0,
                 patches: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Prefill ``tokens`` (B, S), after a VLM's ``patches`` if given, and
    write their K/V **in place** into rows ``row .. row + B - 1`` of
    ``cache``; the slots of those rows past the prompt are zeroed, so a
    reused row keeps nothing of its last request. Returns the last-position
    logits (B, V)."""
    x = embed_inputs(cfg, params, tokens, patches)
    B, S, _ = x.shape
    rows = slice(row, row + B)
    for kind, d in cache.items():
        for c in d.values():                        # (g, cnt, batch, slots, hkv, hd)
            if _window_of(cfg, kind) == 0 and S > c.shape[3]:
                raise ValueError(f"prompt of {S} tokens does not fit "
                                 f"{c.shape[3]} cache slots")
            c[:, :, rows, S:].zero_()
    positions = torch.arange(S, device=x.device)[None, :]
    pat = layer_pattern(cfg)
    kind_of = _kind_slots(pat)
    layers = unstack(params["blocks"])
    for gi in range(n_groups(cfg)):
        for i, kind in enumerate(pat):
            x, k, v, _ = _block(cfg, layers[gi][i], x, positions, kind)
            _, slot = kind_of[i]
            _to_cache_slots(cache[kind]["k"][gi, slot, rows], k)
            _to_cache_slots(cache[kind]["v"][gi, slot, rows], v)
    # the norm is row-wise: normalising the last position only is the same
    x = ops.rmsnorm(x[:, -1:, :].contiguous(), params["final_norm"], cfg.norm_eps)
    return unembed(cfg, params, x)[:, 0, :]


def _to_cache_slots(c: torch.Tensor, k: torch.Tensor) -> None:
    """Lay prefill K/V k (B, S, hkv, hd) into cache rows c (B, slots, hkv, hd)
    in place. A prompt longer than a window layer's ring keeps its last
    ``slots`` tokens, each at its ring position ``pos % slots``."""
    S, slots = k.shape[1], c.shape[1]
    if S <= slots:
        c[:, :S] = k
    else:
        c.copy_(torch.roll(k[:, -slots:], S % slots, dims=1))
