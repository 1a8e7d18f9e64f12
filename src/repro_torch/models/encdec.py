"""Whisper-style encoder-decoder backbone, the audio family (port of
``repro.models.encdec``).

The conv/mel frontend is a stub, as in ``repro``: the model takes
precomputed frame embeddings (B, n_frames, d_model), cast at the model's
entry to the parameters' dtype. The encoder is bidirectional over the
frames with sinusoidal positions; the decoder is causal self-attention,
then cross-attention to the encoder output, with sinusoidal positions and
no RoPE. Norms and MLPs follow the repo-wide RMSNorm/SwiGLU convention.

Every attention goes through ``kernels.ops`` (``flash_attention`` where it
may be differentiated, ``flash_attention_fwd`` in decode), every norm
through ``ops.rmsnorm``: the encoder's is non-causal with S = T = n_frames,
the cross-attention non-causal with S = the decoder length and T =
n_frames, a decode step's self-attention non-causal with a per-row
``kv_len = pos + 1``. ``decode_step`` takes an int or per-row positions,
as ``transformer.decode_step`` does; ``repro``'s takes one scalar.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple, Union

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..kernels import ops
from .layers import (
    P,
    Schema,
    attention_schema,
    embed,
    mlp_schema,
    qkv_project,
    row_parallel,
    sinusoidal_table,
    split_heads,
    stack_schema,
    swiglu,
)
from .transformer import (REMAT, attend_cached, decode_slots, row_positions, unembed,
                          unstack)


def encdec_schema(cfg: ModelConfig) -> Schema:
    e = cfg.encdec
    assert e is not None
    enc_block = {
        "ln1": P((cfg.d_model,), ("embed",), "ones"),
        "attn": attention_schema(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                 cfg.head_dim_, cfg.qkv_bias),
        "ln2": P((cfg.d_model,), ("embed",), "ones"),
        "ffn": mlp_schema(cfg.d_model, cfg.d_ff),
    }
    dec_block = {
        "ln1": P((cfg.d_model,), ("embed",), "ones"),
        "self_attn": attention_schema(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                      cfg.head_dim_, cfg.qkv_bias),
        "ln_x": P((cfg.d_model,), ("embed",), "ones"),
        "cross_attn": attention_schema(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                       cfg.head_dim_, cfg.qkv_bias),
        "ln2": P((cfg.d_model,), ("embed",), "ones"),
        "ffn": mlp_schema(cfg.d_model, cfg.d_ff),
    }
    return {
        "encoder": {
            "blocks": stack_schema(enc_block, e.n_encoder_layers, "layers"),
            "final_norm": P((cfg.d_model,), ("embed",), "ones"),
        },
        "embed": {"table": P((cfg.vocab, cfg.d_model), ("vocab", "embed"))},
        "blocks": stack_schema(dec_block, cfg.n_layers, "layers"),
        "final_norm": P((cfg.d_model,), ("embed",), "ones"),
        "lm_head": P((cfg.d_model, cfg.vocab), ("embed", "vocab")),
    }


def _mlp(cfg: ModelConfig, p: Dict[str, Any], h: torch.Tensor) -> torch.Tensor:
    """The pre-normed SwiGLU residual branch."""
    hh = ops.rmsnorm(h, p["ln2"], cfg.norm_eps)
    return swiglu(hh, p["ffn"]["w_gate"], p["ffn"]["w_up"], p["ffn"]["w_down"])


def encode(cfg: ModelConfig, params: Dict[str, Any], frames: torch.Tensor) -> torch.Tensor:
    """frames: (B, n_frames, d_model) stub embeddings → encoder states, in
    the parameters' dtype (frames of another dtype are cast to it first)."""
    frames = frames.to(params["embed"]["table"].dtype)
    B, F, D = frames.shape
    x = frames + sinusoidal_table(F, D, frames.device, frames.dtype)[None]
    for p in unstack(params["encoder"]["blocks"], 1):
        hh = ops.rmsnorm(x, p["ln1"], cfg.norm_eps)
        q, k, v = qkv_project(hh, p["attn"], cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_)
        o = ops.flash_attention(q, k, v, causal=False)
        x = x + row_parallel(o.reshape(B, F, -1), p["attn"]["wo"])
        x = x + _mlp(cfg, p, x)
    return ops.rmsnorm(x, params["encoder"]["final_norm"], cfg.norm_eps)


def _cross_q(cfg: ModelConfig, p: Dict[str, Any], h: torch.Tensor) -> torch.Tensor:
    """The cross-attention's queries from the decoder stream h (B, S, d)."""
    B, S = h.shape[:2]
    hh = ops.rmsnorm(h, p["ln_x"], cfg.norm_eps)
    q = hh @ p["cross_attn"]["wq"]
    if "bq" in p["cross_attn"]:
        q = q + p["cross_attn"]["bq"]
    return split_heads(q, cfg.n_heads, cfg.head_dim_)


def _dec_block(cfg: ModelConfig, p: Dict[str, Any], h: torch.Tensor,
               enc_kv: Tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """Causal self-attention, cross-attention to the encoder's K/V, SwiGLU."""
    B, S = h.shape[:2]
    hh = ops.rmsnorm(h, p["ln1"], cfg.norm_eps)
    q, k, v = qkv_project(hh, p["self_attn"], cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_)
    o = ops.flash_attention(q, k, v, causal=True)
    h = h + row_parallel(o.reshape(B, S, -1), p["self_attn"]["wo"])
    o = ops.flash_attention(_cross_q(cfg, p, h), *enc_kv, causal=False)
    h = h + row_parallel(o.reshape(B, S, -1), p["cross_attn"]["wo"])
    return h + _mlp(cfg, p, h)


def _cross_kv(cfg: ModelConfig, p: Dict[str, Any], enc: torch.Tensor,
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    B, F, _ = enc.shape
    k = enc @ p["cross_attn"]["wk"]
    v = enc @ p["cross_attn"]["wv"]
    if "bk" in p["cross_attn"]:
        k, v = k + p["cross_attn"]["bk"], v + p["cross_attn"]["bv"]
    return (split_heads(k, cfg.n_kv_heads, cfg.head_dim_),
            split_heads(v, cfg.n_kv_heads, cfg.head_dim_))


def forward(cfg: ModelConfig, params: Dict[str, Any], tokens: torch.Tensor,
            frames: torch.Tensor, remat: str = "block",
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (logits (B, S, V), aux_loss 0). ``remat`` other than "none" runs
    each decoder layer (its cross K/V included) under
    ``torch.utils.checkpoint`` and recomputes it in the backward pass, as
    ``jax.checkpoint(body, policy=nothing_saveable)`` does in ``repro``;
    the encoder, as there, is not rematerialised."""
    if remat not in REMAT:
        raise ValueError(f"remat={remat!r}: want one of {REMAT}")
    enc = encode(cfg, params, frames)
    S = tokens.shape[1]
    x = embed(params["embed"]["table"], tokens)
    x = x + sinusoidal_table(S, cfg.d_model, x.device, x.dtype)[None]

    def body(h: torch.Tensor, e: torch.Tensor, p: Dict[str, Any]) -> torch.Tensor:
        return _dec_block(cfg, p, h, _cross_kv(cfg, p, e))

    for p in unstack(params["blocks"], 1):
        if remat != "none" and torch.is_grad_enabled():
            x = checkpoint(body, x, enc, p, use_reentrant=False)
        else:
            x = body(x, enc, p)
    x = ops.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return unembed(cfg, params, x), torch.zeros((), dtype=torch.float32, device=x.device)


# ---------------------------------------------------------------------------
# decode: self-KV cache + precomputed cross-KV
# ---------------------------------------------------------------------------
def _sinusoidal_at(pos_t: torch.Tensor, d: int) -> torch.Tensor:
    """Sinusoidal embeddings at per-row positions (B,) → (B, 1, d), computed
    in f32 as ``repro``'s ``_sinusoidal_at`` (the forward's table is f64
    cast to f32: the two agree to f32 rounding)."""
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=pos_t.device)
    angle = pos_t.float()[:, None] / torch.pow(10000.0, dim / d)
    out = torch.stack([torch.sin(angle), torch.cos(angle)], dim=-1)
    return out.reshape(pos_t.shape[0], -1)[:, None, :d]


def cache_shapes(cfg: ModelConfig, batch: int, max_len: int) -> Dict[str, Any]:
    e = cfg.encdec
    assert e is not None
    hkv, hd = cfg.n_kv_heads, cfg.head_dim_
    L = cfg.n_layers
    return {
        "self_k": (L, batch, max_len, hkv, hd),
        "self_v": (L, batch, max_len, hkv, hd),
        "cross_k": (L, batch, e.n_frames, hkv, hd),
        "cross_v": (L, batch, e.n_frames, hkv, hd),
    }


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> Dict[str, Any]:
    return {k: torch.zeros(s, dtype=dtype, device=device)
            for k, s in cache_shapes(cfg, batch, max_len).items()}


def decode_step(cfg: ModelConfig, params: Dict[str, Any], cache: Dict[str, Any],
                token: torch.Tensor, pos: Union[int, torch.Tensor],
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decode step. token: (B,) int; pos: an int, or a (B,) int tensor of
    per-row positions (tokens already in that row's self-attention cache).
    Returns (logits (B, V), cache); the self K/V are written **in place**
    where ``transformer.decode_slots`` says for a full layer, and each row
    attends to its first ``pos + 1`` slots and to all of its cross K/V
    (filled by ``prefill_cross_kv``). With all positions equal this is
    ``repro``'s scalar-pos step."""
    B = token.shape[0]
    pos_t = row_positions(pos, B, token.device)
    rows, write, kv_len = decode_slots(pos_t, cache["self_k"].shape[2])
    x = embed(params["embed"]["table"], token)[:, None, :]
    x = x + _sinusoidal_at(pos_t, cfg.d_model).to(x.dtype)
    for li, p in enumerate(unstack(params["blocks"], 1)):
        hh = ops.rmsnorm(x, p["ln1"], cfg.norm_eps)
        q, k, v = qkv_project(hh, p["self_attn"], cfg.n_heads, cfg.n_kv_heads,
                              cfg.head_dim_)
        o = attend_cached(q, k, v, cache["self_k"][li], cache["self_v"][li],
                          (rows, write, kv_len))
        x = x + row_parallel(o.reshape(B, 1, -1), p["self_attn"]["wo"])
        o = ops.flash_attention(_cross_q(cfg, p, x), cache["cross_k"][li],
                                cache["cross_v"][li], causal=False)
        x = x + row_parallel(o.reshape(B, 1, -1), p["cross_attn"]["wo"])
        x = x + _mlp(cfg, p, x)
    x = ops.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return unembed(cfg, params, x)[:, 0, :], cache


def prefill_cross_kv(cfg: ModelConfig, params: Dict[str, Any], frames: torch.Tensor,
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Encoder pass + every decoder layer's cross K/V (the decode-time
    constants): → (cross_k, cross_v), each (L, B, n_frames, hkv, hd)."""
    enc = encode(cfg, params, frames)
    kv = [_cross_kv(cfg, p, enc) for p in unstack(params["blocks"], 1)]
    return torch.stack([k for k, _ in kv]), torch.stack([v for _, v in kv])
