"""Mamba2 / SSD blocks and the pure-SSM LM stack (port of
``repro.models.mamba2``).

The prefill path runs the chunked SSD through ``kernels.ops.ssd_scan`` (the
hand-written kernel on CUDA, its plain version on CPU), which also returns
each sequence's final state; ``prefill_into`` leaves that state and the conv
tail in a serving slot in one pass, the state ``repro``'s batcher reaches by
feeding the prompt token by token. Decode runs the O(1)-per-token recurrent
form in plain PyTorch (XLA in ``repro``) on a (conv, ssm) cache, updated in
place. ``repro``'s roundings are kept: dt and a are cast to the model dtype
before the scan, and the decode state lives and is updated in the cache
dtype. Both norms of a layer go through ``ops.rmsnorm``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple, Union

import torch
from torch.distributed.tensor import DTensor
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..kernels import ops
from ..shards import prefill_rows
from .layers import P, Schema, embed, stack_schema
from .transformer import REMAT, init_sharded_cache, on_shards, unstack


def ssm_dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    """→ (d_inner, SSD heads, B/C groups, state dim N)."""
    s = cfg.ssm
    assert s is not None
    d_in = s.expand * cfg.d_model
    return d_in, d_in // s.head_dim, s.n_groups, s.state_dim


def mamba_schema(cfg: ModelConfig) -> Schema:
    s = cfg.ssm
    assert s is not None
    d_in, nh, g, n = ssm_dims(cfg)
    conv_ch = d_in + 2 * g * n
    proj_out = 2 * d_in + 2 * g * n + nh
    return {
        "in_proj": P((cfg.d_model, proj_out), ("embed", "ssm_inner")),
        "conv_w": P((s.conv_width, conv_ch), (None, "ssm_inner")),
        "conv_b": P((conv_ch,), ("ssm_inner",), "zeros"),
        "a_log": P((nh,), (None,), "ssm_a"),
        "dt_bias": P((nh,), (None,), "dt_bias"),
        "d_skip": P((nh,), (None,), "ones"),
        "norm": P((d_in,), ("ssm_inner",), "ones"),
        "out_proj": P((d_in, cfg.d_model), ("ssm_inner", "embed")),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along seq. x: (B, S, C); w: (W, C)."""
    W, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, W - 1, 0))
    return sum(xp[:, i:i + S, :] * w[i] for i in range(W)) + b


def _split_proj(zxbcdt: torch.Tensor, cfg: ModelConfig):
    """in_proj output → (z, xBC, dt) along the last dim."""
    d_in, nh, g, n = ssm_dims(cfg)
    return torch.split(zxbcdt, [d_in, d_in + 2 * g * n, nh], dim=-1)


def _dt_and_a(dt: torch.Tensor, p: Dict[str, torch.Tensor]):
    """softplus(dt + dt_bias) and a = -exp(a_log), both in f32."""
    return (F.softplus(dt.float() + p["dt_bias"].float()),
            -torch.exp(p["a_log"].float()))


def mamba_block(x: torch.Tensor, p: Dict[str, torch.Tensor], cfg: ModelConfig,
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full Mamba2 block (prefill / training path). x: (B, S, d_model) →
    (out (B, S, d_model), conv tail (B, W-1, C): the last W-1 pre-conv xBC
    rows, zero-padded on the left for S < W-1, final SSM state (B, H, P, N)
    in f32)."""
    s = cfg.ssm
    assert s is not None
    d_in, nh, g, n = ssm_dims(cfg)
    Bb, S, _ = x.shape

    z, xBC_in, dt = _split_proj(x @ p["in_proj"], cfg)
    xBC = F.silu(_causal_conv(xBC_in, p["conv_w"], p["conv_b"]))
    xs, B_, C_ = torch.split(xBC, [d_in, g * n, g * n], dim=-1)
    xh = xs.reshape(Bb, S, nh, s.head_dim)
    B_ = B_.reshape(Bb, S, g, n)
    C_ = C_.reshape(Bb, S, g, n)
    dt, a = _dt_and_a(dt, p)
    y, h_final = ops.ssd_scan(xh, dt.to(x.dtype), a.to(x.dtype), B_, C_, chunk=s.chunk)
    y = y + xh * p["d_skip"].to(x.dtype)[None, None, :, None]
    y = ops.rmsnorm(y.reshape(Bb, S, d_in) * F.silu(z), p["norm"], cfg.norm_eps)
    out = y @ p["out_proj"]
    W = s.conv_width
    tail = xBC_in[:, -(W - 1):] if S >= W - 1 else F.pad(xBC_in, (0, 0, W - 1 - S, 0))
    return out, tail, h_final


# ---------------------------------------------------------------------------
# decode (recurrent form)
# ---------------------------------------------------------------------------
def mamba_cache_shape(cfg: ModelConfig, batch: int) -> Dict[str, Tuple[int, ...]]:
    s = cfg.ssm
    d_in, nh, g, n = ssm_dims(cfg)
    return {"conv": (batch, s.conv_width - 1, d_in + 2 * g * n),
            "ssm": (batch, nh, s.head_dim, n)}


def mamba_decode_step(x: torch.Tensor, cache: Dict[str, torch.Tensor],
                      p: Dict[str, torch.Tensor], cfg: ModelConfig,
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token step. x: (B, d_model); cache: {"conv" (B, W-1, C), "ssm"
    (B, H, P, N)} → (out (B, d_model), the new {"conv", "ssm"}; the state in
    the cache's dtype)."""
    s = cfg.ssm
    assert s is not None
    d_in, nh, g, n = ssm_dims(cfg)
    Bb = x.shape[0]

    z, xBC, dt = _split_proj(x @ p["in_proj"], cfg)
    # causal conv over (cached W-1 inputs + current)
    conv_in = torch.cat([cache["conv"], xBC[:, None, :]], dim=1)        # (B, W, C)
    xBC_t = F.silu(torch.einsum("bwc,wc->bc", conv_in, p["conv_w"]) + p["conv_b"])
    xs, B_, C_ = torch.split(xBC_t, [d_in, g * n, g * n], dim=-1)
    xh = xs.reshape(Bb, nh, s.head_dim)
    r = nh // g
    dt, a = _dt_and_a(dt, p)
    dA = torch.exp(dt * a[None, :])                                      # (B, nh)

    h = cache["ssm"]
    hd = h.dtype
    h = h.reshape(Bb, g, r, s.head_dim, n)
    xdt = (xh * dt[..., None]).reshape(Bb, g, r, s.head_dim)
    h_new = (h * dA.reshape(Bb, g, r)[..., None, None].to(hd)
             + torch.einsum("bgrp,bgn->bgrpn", xdt.to(hd), B_.reshape(Bb, g, n).to(hd)))
    y = torch.einsum("bgn,bgrpn->bgrp", C_.reshape(Bb, g, n).to(hd), h_new)
    y = y.reshape(Bb, nh, s.head_dim) + xh * p["d_skip"].to(x.dtype)[None, :, None]
    y = ops.rmsnorm(y.reshape(Bb, d_in) * F.silu(z), p["norm"], cfg.norm_eps)
    return y @ p["out_proj"], {"conv": conv_in[:, 1:],
                               "ssm": h_new.reshape(Bb, nh, s.head_dim, n)}


def step_layer(x: torch.Tensor, p: Dict[str, torch.Tensor], conv: torch.Tensor,
               ssm: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """One residual Mamba layer of a decode step, writing the layer's new
    conv and SSM state into its cache rows ``conv``/``ssm`` in place."""
    y, st = mamba_decode_step(ops.rmsnorm(x, p["ln"], cfg.norm_eps),
                              {"conv": conv, "ssm": ssm}, p, cfg)
    conv.copy_(st["conv"])
    ssm.copy_(st["ssm"])
    return x + y


def prefill_layer(x: torch.Tensor, p: Dict[str, torch.Tensor], conv: torch.Tensor,
                  ssm: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """One residual Mamba layer of a prefill, writing the sequences' conv
    tails and final states into cache rows ``conv``/``ssm`` in place (the
    state cast once to the cache's dtype)."""
    y, tail, h_final = mamba_block(ops.rmsnorm(x, p["ln"], cfg.norm_eps), p, cfg)
    if isinstance(conv, DTensor):
        on_shards(torch.Tensor.copy_, conv, tail)
        on_shards(torch.Tensor.copy_, ssm, h_final)
    else:
        conv.copy_(tail)
        ssm.copy_(h_final)
    return x + y


# ---------------------------------------------------------------------------
# pure-SSM language model stack (mamba2-370m family)
# ---------------------------------------------------------------------------
def ssm_lm_schema(cfg: ModelConfig) -> Schema:
    layer = {"ln": P((cfg.d_model,), ("embed",), "ones"), **mamba_schema(cfg)}
    return {
        "embed": {"table": P((cfg.vocab, cfg.d_model), ("vocab", "embed"))},
        "layers": stack_schema(layer, cfg.n_layers, "layers"),
        "final_norm": P((cfg.d_model,), ("embed",), "ones"),
        "lm_head": P((cfg.d_model, cfg.vocab), ("embed", "vocab")),
    }


def ssm_forward(cfg: ModelConfig, params: Dict[str, Any], tokens: torch.Tensor,
                remat: str = "block") -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (logits (B, S, V), aux 0). With ``remat`` other than "none" each
    layer runs under ``torch.utils.checkpoint`` where grad is on, as
    ``jax.checkpoint(body, nothing_saveable)`` does in ``repro``."""
    if remat not in REMAT:
        raise ValueError(f"remat={remat!r}: want one of {REMAT}")
    x = embed(params["embed"]["table"], tokens)
    layers: List[Dict[str, Any]] = unstack(params["layers"], depth=1)

    def body(h: torch.Tensor, li: int) -> torch.Tensor:
        p = layers[li]
        return h + mamba_block(ops.rmsnorm(h, p["ln"], cfg.norm_eps), p, cfg)[0]

    for li in range(cfg.n_layers):
        if remat != "none" and torch.is_grad_enabled():
            x = checkpoint(body, x, li, use_reentrant=False)
        else:
            x = body(x, li)
    x = ops.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return x @ params["lm_head"], torch.zeros((), dtype=torch.float32, device=x.device)


def ssm_cache_shapes(cfg: ModelConfig, batch: int, max_len: int = 0
                     ) -> Dict[str, Tuple[int, ...]]:
    """repro's layout: {"conv": (L, B, W-1, C), "ssm": (L, B, H, P, N)}; no
    positions, so ``max_len`` does not enter."""
    ms = mamba_cache_shape(cfg, batch)
    return {k: (cfg.n_layers, *v) for k, v in ms.items()}


def ssm_init_cache(cfg: ModelConfig, batch: int, max_len: int = 0,
                   dtype=torch.bfloat16, device=None) -> Dict[str, torch.Tensor]:
    return {k: torch.zeros(s, dtype=dtype, device=device)
            for k, s in ssm_cache_shapes(cfg, batch, max_len).items()}


def ssm_decode_step(cfg: ModelConfig, params: Dict[str, Any],
                    cache: Dict[str, torch.Tensor], token: torch.Tensor,
                    pos: Union[int, torch.Tensor] = 0,
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One token for every row: → (logits (B, V), cache), the cache updated
    **in place**. The state carries the position, so ``pos`` (an int or per
    row) is taken for the common signature and not read."""
    x = embed(params["embed"]["table"], token)                 # (B, d)
    for li, p in enumerate(unstack(params["layers"], depth=1)):
        x = step_layer(x, p, cache["conv"][li], cache["ssm"][li], cfg)
    x = ops.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return x @ params["lm_head"], cache


def ssm_prefill(cfg: ModelConfig, params: Dict[str, Any], tokens: torch.Tensor,
                max_len: int = 0) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """→ (last-position logits (B, V), a fresh cache holding the prompt's
    state)."""
    table = params["embed"]["table"]
    if isinstance(tokens, DTensor):
        cache = init_sharded_cache(lambda b: ssm_cache_shapes(cfg, b, max_len), tokens,
                                   table.dtype)
    else:
        cache = ssm_init_cache(cfg, tokens.shape[0], max_len, table.dtype, table.device)
    return ssm_prefill_into(cfg, params, tokens, cache, 0), cache


def ssm_prefill_into(cfg: ModelConfig, params: Dict[str, Any], tokens: torch.Tensor,
                     cache: Dict[str, torch.Tensor], row: int = 0) -> torch.Tensor:
    """Prefill ``tokens`` (B, S) and overwrite rows ``row .. row + B - 1`` of
    every layer's conv and SSM state in place: what ``repro``'s batcher
    leaves there by feeding the prompt token by token from a clean slot.
    Returns the last-position logits (B, V)."""
    x = embed(params["embed"]["table"], tokens)
    rows = prefill_rows(x, row)
    for li, p in enumerate(unstack(params["layers"], depth=1)):
        x = prefill_layer(x, p, cache["conv"][li][rows], cache["ssm"][li][rows], cfg)
    # the norm is row-wise: normalising the last position only is the same
    x = ops.rmsnorm(x[:, -1:, :].contiguous(), params["final_norm"], cfg.norm_eps)
    return (x @ params["lm_head"])[:, 0, :]
