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

On a device mesh the parameters, inputs and cache are DTensors. A decode
step's cache may be sharded over its slots (``decode_rules``' "kv_seq"):
each rank then writes the new K/V where the slot falls in its range,
attends over its own slots, and the ranks' partial outputs are merged by
their logsumexp (``_sharded_attend_one``). The prefill makes its cache
with the batch placed as the tokens are, and writes it shard by shard.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple, Union

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor import zeros as dtensor_zeros
from torch.distributed.tensor.experimental import local_map
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..kernels import ops
from ..shards import local_shape_and_offset, place, prefill_rows
from ..spans import span
from .layers import (
    P,
    Schema,
    apply_rope,
    attention_schema,
    embed,
    mlp_schema,
    qkv_project,
    row_parallel,
    stack_schema,
    swiglu,
)
from .moe import _constrain, moe_ffn, moe_schema

REMAT = ("none", "block", "full")

# Sequence parallelism: shard the residual stream's seq dim over the "model"
# axis when a *global* microbatch residual exceeds this size (``repro``'s
# threshold). Shrinks each layer group's saved input by the TP degree;
# attention gathers the sequence back (``ops.flash_attention``).
SEQ_SHARD_MIN_BYTES = 256 << 20


def maybe_seq_shard(h: torch.Tensor) -> torch.Tensor:
    if h.dim() == 3 and h.numel() * h.element_size() > SEQ_SHARD_MIN_BYTES:
        return _constrain(h, ("pod", "data"), "model", None)
    return h


def to_residual(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A block's output y placed as the residual stream x before they are
    added: with x sequence-sharded, y's partial sums (the row-parallel
    product's) are reduce-scattered over the sequence here, in a step that
    autograd sees, so that the gradient comes back gathered. The identity
    when the placements already agree or on plain tensors."""
    return place(y, x.placements) if isinstance(y, DTensor) else y


def seq_whole(h: torch.Tensor) -> torch.Tensor:
    """A sequence-sharded DTensor (``maybe_seq_shard``'s) gathered over its
    sequence: the products that follow a norm read whole rows of tokens
    (sequence parallelism's all-gather before the column-parallel
    products; the row-parallel output's reduce comes back as a
    reduce-scatter into the sharded residual). The identity otherwise."""
    if isinstance(h, DTensor) and Shard(1) in h.placements:
        return place(h, tuple(Replicate() if p == Shard(1) else p for p in h.placements))
    return h


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
    return row_parallel(o.reshape(B, S, -1), p["wo"]), k, v


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
    o = attend_cached(q, k, v, kc, vc, at)
    return row_parallel(o.reshape(h.shape[0], 1, -1), p["wo"])


def attend_cached(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kc: torch.Tensor,
                  vc: torch.Tensor, at: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
                  ) -> torch.Tensor:
    """Write one step's k, v (B, 1, hkv, hd) into the cache rows kc/vc where
    ``at`` says and attend with q (B, 1, Hq, hd) to each row's first kv_len
    slots: → O (B, 1, Hq, hd). A sharded cache goes through
    ``_sharded_attend_one``."""
    if isinstance(kc, DTensor):
        return _sharded_attend_one(q, k, v, kc, vc, at)
    rows, write, kv_len = at
    kc[rows, write] = k[:, 0]
    vc[rows, write] = v[:, 0]
    return ops.flash_attention_fwd(q, kc, vc, causal=False, window=0, kv_len=kv_len)[0]


def _attend_local(q, k, v, kc, vc, write, kv_len, slot0: int):
    """One rank's part of a decode step over its cache slots
    ``[slot0, slot0 + slots)``: writes row b's K/V if ``write[b]`` falls
    there, attends over its valid slots, → (O (1, b, 1, Hq, D), lse
    (1, b, 1, Hq) f32, -inf for a row with none of its slots valid)."""
    b, slots = kc.shape[0], kc.shape[1]
    w = write - slot0
    mine = ((w >= 0) & (w < slots))[:, None, None]
    rows, w = torch.arange(b, device=kc.device), w.clamp(0, slots - 1)
    # a row whose slot lies on another rank writes back what it read
    kc[rows, w] = torch.where(mine, k[:, 0], kc[rows, w])
    vc[rows, w] = torch.where(mine, v[:, 0], vc[rows, w])
    n = (kv_len - slot0).clamp(0, slots).to(torch.int32)
    o, lse = ops.flash_attention_fwd(q, kc, vc, causal=False, window=0,
                                     kv_len=n.clamp(min=1))
    lse = lse.view(b, q.shape[2], 1).transpose(1, 2)               # (b, 1, Hq)
    valid = (n > 0)[:, None, None]
    return (torch.where(valid[..., None], o, torch.zeros_like(o))[None],
            torch.where(valid, lse, torch.full_like(lse, float("-inf")))[None])


def _sharded_attend_one(q: DTensor, k: DTensor, v: DTensor, kc: DTensor, vc: DTensor,
                        at: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]) -> DTensor:
    """A decode step's attention against a cache (B, slots, hkv, hd) whose
    batch and slots may be sharded. q, k, v keep the cache's batch
    placement and are gathered on every other mesh dim (all heads); each
    rank runs ``_attend_local`` on its slots; where the slots are split,
    the partial outputs are gathered and merged by their logsumexp."""
    mesh = kc.device_mesh
    cp = tuple(p if p in (Shard(0), Shard(1)) else Replicate() for p in kc.placements)
    qp = tuple(Shard(0) if p == Shard(0) else Replicate() for p in cp)
    # the heads' all-gather: every rank attends with all heads
    q, k, v = (place(t, qp) for t in (q, k, v))
    kc, vc = place(kc, cp), place(vc, cp)
    _, offset = local_shape_and_offset(kc.shape, mesh, cp)
    _, write, kv_len = at
    b_off = local_shape_and_offset(q.shape, mesh, qp)[1][0]
    nb = q.to_local().shape[0]
    part = tuple(Shard(0) if p == Shard(1) else (Shard(1) if p == Shard(0) else Replicate())
                 for p in cp)
    fn = local_map(lambda ql, kl, vl, kcl, vcl: _attend_local(
                       ql, kl, vl, kcl, vcl, write[b_off:b_off + nb],
                       kv_len[b_off:b_off + nb], offset[1]),
                   out_placements=(list(part), list(part)),
                   in_placements=(qp, qp, qp, cp, cp), device_mesh=mesh)
    o, lse = fn(q, k, v, kc, vc)
    if o.shape[0] == 1:                  # the slots are whole on every rank
        return o[0]
    # the partial outputs' all-gather over the slot-splitting mesh dims
    gathered = tuple(Replicate() if p == Shard(0) else p for p in part)
    o, lse = place(o, gathered), place(lse, gathered)
    wts = torch.exp(lse - lse.amax(0, keepdim=True))               # (m, B, 1, Hq)
    out = (o.float() * wts[..., None]).sum(0) / wts.sum(0)[..., None]
    return out.to(o.dtype)


def _block(cfg: ModelConfig, p: Dict[str, Any], x: torch.Tensor,
           positions: torch.Tensor, kind: str,
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """→ (block output, roped K, V, MoE aux or None) for a full causal
    sequence."""
    o, k, v = attend(cfg, p["attn"], seq_whole(ops.rmsnorm(x, p["ln1"], cfg.norm_eps)),
                     positions, _window_of(cfg, kind))
    x = x + to_residual(o, x)
    y, aux = _ffn(cfg, p["ffn"], seq_whole(ops.rmsnorm(x, p["ln2"], cfg.norm_eps)))
    return x + to_residual(y, x), k, v, aux


def embed_inputs(cfg: ModelConfig, params: Dict[str, Any], tokens: torch.Tensor,
                 patches: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token embeddings (B, S, d); a VLM's patches (B, n_patches, patch_dim),
    cast to the table's dtype and projected by ``vision_proj``, come before
    them: (B, n_patches + S, d)."""
    x = embed(params["embed"]["table"], tokens)
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
        h = maybe_seq_shard(h)
        for i, kind in enumerate(pat):
            h, _, _, a = _block(cfg, layers[gi][i], h, positions, kind)
            if a is not None:
                aux = aux + a
        return maybe_seq_shard(h), aux

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
    x = seq_whole(x)
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
    if isinstance(pos, int) and pos < 0:
        raise ValueError("pos: positions must be >= 0")
    pos_t = torch.as_tensor(pos, dtype=torch.int64)
    if pos_t.dim() == 0:
        pos_t = pos_t.expand(B)
    if pos_t.shape != (B,):
        raise ValueError(f"pos: want an int or shape ({B},), got {tuple(pos_t.shape)}")
    if not isinstance(pos, int) and pos_t.device.type == "cpu" and bool((pos_t < 0).any()):
        raise ValueError("pos: positions must be >= 0")
    with span("model.upload", wait=True):
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

    x = embed(params["embed"]["table"], token)[:, None, :]     # (B, 1, d)
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
    if isinstance(tokens, DTensor):
        cache = init_sharded_cache(lambda b: cache_shapes(cfg, b, max_len), tokens,
                                   table.dtype)
    else:
        cache = init_cache(cfg, B, max_len, table.dtype, table.device)
    return prefill_into(cfg, params, tokens, cache, 0, patches), cache


def init_sharded_cache(shapes_of, tokens: DTensor, dtype: torch.dtype) -> Dict[str, Any]:
    """A zero cache of DTensors on the tokens' mesh: ``shapes_of(batch)``
    gives its shape tree; each leaf's batch dim (the one that grows with
    the batch) is placed as the tokens' batch, every other dim whole."""
    mesh, B = tokens.device_mesh, tokens.shape[0]

    def leaf(shape: Tuple[int, ...], wider: Tuple[int, ...]) -> DTensor:
        d = next(i for i, (a, b) in enumerate(zip(shape, wider)) if a != b)
        pl = tuple(Shard(d) if p == Shard(0) else Replicate() for p in tokens.placements)
        return dtensor_zeros(shape, dtype=dtype, device_mesh=mesh, placements=pl)

    def walk(a: Any, b: Any) -> Any:
        return {k: walk(a[k], b[k]) for k in a} if isinstance(a, dict) else leaf(a, b)

    return walk(shapes_of(B), shapes_of(B + 1))


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
    rows = prefill_rows(x, row)
    sharded = isinstance(x, DTensor)
    for kind, d in cache.items():
        for c in d.values():                        # (g, cnt, batch, slots, hkv, hd)
            if _window_of(cfg, kind) == 0 and S > c.shape[3]:
                raise ValueError(f"prompt of {S} tokens does not fit "
                                 f"{c.shape[3]} cache slots")
            if sharded:
                on_shards(lambda cl: cl[:, :, :, S:].zero_(), c)
            else:
                c[:, :, rows, S:].zero_()
    positions = torch.arange(S, device=x.device)[None, :]
    pat = layer_pattern(cfg)
    kind_of = _kind_slots(pat)
    layers = unstack(params["blocks"])
    for gi in range(n_groups(cfg)):
        for i, kind in enumerate(pat):
            x, k, v, _ = _block(cfg, layers[gi][i], x, positions, kind)
            _, slot = kind_of[i]
            if sharded:
                on_shards(_to_cache_slots, cache[kind]["k"][gi, slot], k)
                on_shards(_to_cache_slots, cache[kind]["v"][gi, slot], v)
            else:
                _to_cache_slots(cache[kind]["k"][gi, slot, rows], k)
                _to_cache_slots(cache[kind]["v"][gi, slot, rows], v)
    # the norm is row-wise: normalising the last position only is the same
    x = ops.rmsnorm(x[:, -1:, :].contiguous(), params["final_norm"], cfg.norm_eps)
    return unembed(cfg, params, x)[:, 0, :]


def on_shards(fn, c: DTensor, *src: DTensor) -> None:
    """``fn(local c, *local src)`` on every rank, writing c's shard in
    place; each ``src`` is first brought to c's placements."""
    pl = tuple(c.placements)
    src = tuple(place(t, pl) for t in src)
    def body(*local: torch.Tensor) -> None:
        fn(*local)

    local_map(body, out_placements=(None,), in_placements=(pl,) * (1 + len(src)),
              device_mesh=c.device_mesh)(c, *src)


def _to_cache_slots(c: torch.Tensor, k: torch.Tensor) -> None:
    """Lay prefill K/V k (B, S, hkv, hd) into cache rows c (B, slots, hkv, hd)
    in place. A prompt longer than a window layer's ring keeps its last
    ``slots`` tokens, each at its ring position ``pos % slots``."""
    S, slots = k.shape[1], c.shape[1]
    if S <= slots:
        c[:, :S] = k
    else:
        c.copy_(torch.roll(k[:, -slots:], S % slots, dims=1))
