"""Shared model primitives (PyTorch port of ``repro.models.layers``).

Parameters are described by a *schema*: a nested dict whose leaves are
``P(shape, axes, init)``. The same schema yields
  * ``init_params``  — materialised tensors, from an explicit ``torch.Generator``,
  * ``param_specs``  — tensors on the ``meta`` device (no allocation),
  * ``param_axes``   — each leaf's logical axes, for the sharding rules.
Parameter trees are nested dicts of tensors with ``repro``'s key paths, so
the two frameworks' trees correspond leaf by leaf.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..shards import place


@dataclass(frozen=True)
class P:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"         # normal | zeros | ones | ssm_a | dt_bias
    scale: float = 1.0

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


Schema = Dict[str, Any]          # nested dict of P


def stack_schema(schema: Schema, n: int, axis_name: Optional[str] = "layers") -> Schema:
    """Prepend a stacking dimension (the layer loop indexes it)."""
    out: Schema = {}
    for k, v in schema.items():
        if isinstance(v, dict):
            out[k] = stack_schema(v, n, axis_name)
        else:
            out[k] = P((n, *v.shape), (axis_name, *v.axes), v.init, v.scale)
    return out


# most elements drawn at once in f32 by ``_init_leaf``: 1 GiB of scratch
INIT_CHUNK = 1 << 28


def _init_leaf(p: P, gen: torch.Generator, dtype: torch.dtype,
               device: torch.device) -> torch.Tensor:
    if p.init == "zeros":
        return torch.zeros(p.shape, dtype=dtype, device=device)
    if p.init == "ones":
        return torch.ones(p.shape, dtype=dtype, device=device)
    if p.init in ("ssm_a", "dt_bias"):
        # Mamba2's: A_log = log U[1, 16]; dt_bias = softplus^-1 of dt ~
        # U[1e-3, 1e-1]; drawn in f32, cast once
        lo, hi = (1.0, 16.0) if p.init == "ssm_a" else (1e-3, 1e-1)
        u = torch.empty(p.shape, dtype=torch.float32, device=device).uniform_(
            lo, hi, generator=gen)
        return (torch.log(u) if p.init == "ssm_a" else torch.log(torch.expm1(u))).to(dtype)
    if p.init != "normal":
        raise ValueError(f"unknown init {p.init!r}")
    # truncated-normal fan-in init: the distribution of repro's init (its
    # threefry values cannot be reproduced here). A leaf of more than
    # INIT_CHUNK elements is drawn a block of whole rows at a time, straight
    # into the result: a stacked expert leaf (48 layers x 128 experts x
    # 2048 x 768) would otherwise need twice its size again in f32 scratch.
    fan_in = p.shape[-2] if len(p.shape) >= 2 else p.shape[-1]
    std = p.scale / math.sqrt(max(fan_in, 1))
    out = torch.empty(p.shape, dtype=dtype, device=device)
    if out.numel() == 0:
        return out
    rows = out.view(-1, p.shape[-1])
    step = max(1, INIT_CHUNK // p.shape[-1])
    for r0 in range(0, rows.shape[0], step):
        dst = rows[r0:r0 + step]
        u = torch.empty(dst.shape, dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(u, 0.0, 1.0, -2.0, 2.0, generator=gen)
        dst.copy_(u.mul_(std))
    return out


def init_params(schema: Schema, gen: torch.Generator, dtype=torch.bfloat16,
                device=None) -> Dict[str, Any]:
    """Materialise the schema on ``device`` (default: the generator's)."""
    device = torch.device(device) if device is not None else gen.device
    leaves = {path: _init_leaf(p, gen, dtype, device)
              for path, p in _flatten(schema).items()}
    return _unflatten(leaves)


def param_specs(schema: Schema, dtype=torch.bfloat16) -> Dict[str, Any]:
    return _unflatten({path: torch.empty(p.shape, dtype=dtype, device="meta")
                       for path, p in _flatten(schema).items()})


def param_axes(schema: Schema) -> Dict[str, Any]:
    """The parameter tree's logical axes: a tuple per leaf."""
    return _unflatten({path: p.axes for path, p in _flatten(schema).items()})


def _flatten(schema: Schema, prefix: str = "") -> Dict[str, P]:
    out: Dict[str, P] = {}
    for k in sorted(schema):
        v = schema[k]
        path = f"{prefix}/{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, path))
        else:
            out[path] = v
    return out


def _unflatten(leaves: Dict[str, Any]) -> Dict[str, Any]:
    root: Dict[str, Any] = {}
    for path, v in leaves.items():
        parts = path.strip("/").split("/")
        d = root
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return root


def tree_leaves(tree) -> List[Any]:
    """The leaves of nested dicts (parameters, caches), in key order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Rows of the embedding table (V, d) for int tokens: → (*tokens.shape,
    d). On a DTensor table sharded over the vocab, each rank looks up the
    tokens its shard holds and the rows are summed over the shards
    (DTensor's vocab-parallel embedding; the sum is this all-reduce of the
    rows): the table is never gathered."""
    x = F.embedding(tokens, table)
    if isinstance(x, DTensor) and any(p.is_partial() for p in x.placements):
        x = place(x, tuple(Replicate() if p.is_partial() else p for p in x.placements))
    return x


def count_params(tree) -> int:
    if isinstance(tree, dict):
        return sum(count_params(v) for v in tree.values())
    return tree.numel()


# ---------------------------------------------------------------------------
# numerics
# ---------------------------------------------------------------------------
def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """``repro.models.layers.rmsnorm``: casts to x's dtype *before* the scale
    multiply. The model calls the fused kernel (``kernels.ops.rmsnorm``),
    which multiplies in f32 and casts once; in bf16 the two round apart."""
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * scale


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


# ---------------------------------------------------------------------------
# rotary position embedding
# ---------------------------------------------------------------------------
def rope_frequencies(head_dim: int, fraction: float, theta: float,
                     device=None) -> torch.Tensor:
    rot = int(head_dim * fraction) // 2 * 2
    return 1.0 / (theta ** (torch.arange(0, rot, 2, dtype=torch.float32,
                                         device=device) / rot))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *, fraction: float = 1.0,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) or (S,). Rotates the first
    ``fraction`` of each head dim (chatglm's 2d RoPE = fraction 0.5). Angles
    are f32; each rotated half is cast back to x's dtype."""
    d = x.shape[-1]
    rot = int(d * fraction) // 2 * 2
    if rot == 0:
        return x
    freqs = rope_frequencies(d, fraction, theta, x.device)   # (rot/2,)
    if positions.dim() == 1:
        positions = positions[None, :]
    angles = positions[..., None].float() * freqs              # (B,S,rot/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr[..., : rot // 2], xr[..., rot // 2:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1.to(x.dtype), y2.to(x.dtype), xp], dim=-1)


def sinusoidal_positions(n: int, d: int) -> torch.Tensor:
    """The (n, d) f32 table of sinusoidal positions (sin at even columns,
    cos at odd), ``repro``'s: computed in numpy float64 and cast once to
    f32, so that both frameworks add the same table to their activations."""
    pos = np.arange(n)[:, None]
    dim = np.arange(0, d, 2)[None, :]
    angle = pos / np.power(10000.0, dim / d)
    out = np.zeros((n, d), np.float32)
    out[:, 0::2] = np.sin(angle)
    out[:, 1::2] = np.cos(angle)
    return torch.from_numpy(out)


@functools.lru_cache(maxsize=16)
def sinusoidal_table(n: int, d: int, device: torch.device,
                     dtype: torch.dtype) -> torch.Tensor:
    """``sinusoidal_positions(n, d)`` on ``device`` in ``dtype``, built once
    per (n, d, device, dtype): the encoder and the decoder add it on every
    call. Callers must not write to it."""
    return sinusoidal_positions(n, d).to(device, dtype)


# ---------------------------------------------------------------------------
# attention projections (the attention itself is kernels.ops.flash_attention_fwd)
# ---------------------------------------------------------------------------
def attention_schema(d_model: int, n_heads: int, n_kv_heads: int,
                     head_dim: int, qkv_bias: bool) -> Schema:
    s: Schema = {
        "wq": P((d_model, n_heads * head_dim), ("embed", "heads")),
        "wk": P((d_model, n_kv_heads * head_dim), ("embed", "kv_heads")),
        "wv": P((d_model, n_kv_heads * head_dim), ("embed", "kv_heads")),
        "wo": P((n_heads * head_dim, d_model), ("heads", "embed")),
    }
    if qkv_bias:
        s["bq"] = P((n_heads * head_dim,), ("heads",), "zeros")
        s["bk"] = P((n_kv_heads * head_dim,), ("kv_heads",), "zeros")
        s["bv"] = P((n_kv_heads * head_dim,), ("kv_heads",), "zeros")
    return s


def qkv_project(x: torch.Tensor, p: Dict[str, torch.Tensor], n_heads: int,
                n_kv_heads: int, head_dim: int,
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    B, S, _ = x.shape
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return (split_heads(q, n_heads, head_dim), split_heads(k, n_kv_heads, head_dim),
            split_heads(v, n_kv_heads, head_dim))


def row_parallel(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` where w's rows may be sharded: a replicated x is first split
    along its last dim as w's rows are, in a step autograd sees, so that its
    gradient comes back gathered (whole, as x was) rather than split where
    a reshape before this product cannot take it. Plain tensors multiply."""
    if isinstance(x, DTensor) and isinstance(w, DTensor):
        want = tuple(Shard(x.dim() - 1) if wp == Shard(0) and xp == Replicate() else xp
                     for xp, wp in zip(x.placements, w.placements))
        x = place(x, want)
    return x @ w


def split_heads(t: torch.Tensor, n_heads: int, head_dim: int) -> torch.Tensor:
    """(B, S, n_heads·head_dim) → (B, S, n_heads, head_dim). A DTensor whose
    last dim is split where the cut would fall inside a head (the sharding
    rules shard the flat projection: 2 KV heads of 32 over 4 ranks) is
    gathered on that dim first."""
    if isinstance(t, DTensor):
        mesh = t.device_mesh
        split = [i for i, p in enumerate(t.placements) if p == Shard(2)]
        if n_heads % math.prod(mesh.shape[i] for i in split):
            t = place(t, tuple(Replicate() if i in split else p
                               for i, p in enumerate(t.placements)))
    return t.reshape(t.shape[0], t.shape[1], n_heads, head_dim)


def mlp_schema(d_model: int, d_ff: int) -> Schema:
    return {
        "w_gate": P((d_model, d_ff), ("embed", "ff")),
        "w_up": P((d_model, d_ff), ("embed", "ff")),
        "w_down": P((d_ff, d_model), ("ff", "embed")),
    }
