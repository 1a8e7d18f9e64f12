"""int8 gradient compression for the cross-pod all-reduce (port of
``repro.optim.compress``).

Per-tensor scale, round half to even (``torch.round``, as ``jnp.round``),
and **error feedback**: the quantisation error is carried to the next step,
so the compression bias vanishes over steps. Only the ``"pod"`` hop is
compressed: within a pod gradients are reduced at full precision, across
pods the all-reduce payload is int8 values summed as int32 and one f32
scale per rank.

``compressed_psum_pod`` is ``repro``'s arithmetic line for line: the int32
sum of the ranks' ``q``, times the mean of their scales, over the pod count.
Trees are nested dicts (or lists and tuples) of tensors.
"""
from __future__ import annotations

from typing import Any, Callable, Tuple

import torch
import torch.distributed as dist


def _tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        out = [_tree_map(fn, t, *(r[i] for r in rest)) for i, t in enumerate(tree)]
        return type(tree)(*out) if hasattr(tree, "_fields") else type(tree)(out)
    return fn(tree, *rest)


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (q int8 in [-127, 127], f32 scale = max|x| / 127 + 1e-12)."""
    scale = x.abs().max() / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compressed_psum_pod(tree: Any, mesh: Any = None, axis_name: str = "pod") -> Any:
    """The mean over the ranks of ``mesh``'s ``axis_name`` group of each
    leaf (a local tensor, each rank's own), through an int8 payload: each
    rank quantizes its leaf; the int32 sum of the ``q`` and the sum of the
    scales are all-reduced; the result is ``qsum · (ssum / n) / n`` in the
    leaf's dtype. ``mesh=None`` reduces over the default group."""
    group = None if mesh is None else mesh.get_group(axis_name)   # None: the world
    npods = dist.get_world_size(group)

    def one(g: torch.Tensor) -> torch.Tensor:
        q, s = quantize_int8(g.to(torch.float32))
        qs = q.to(torch.int32)                      # int8 payload, summed as int32
        dist.all_reduce(qs, group=group)
        ss = s.clone()                              # sum of scales: a bound
        dist.all_reduce(ss, group=group)
        n = torch.tensor(float(npods), dtype=torch.float32, device=g.device)
        return (qs.to(torch.float32) * (ss / n) / n).to(g.dtype)

    return _tree_map(one, tree)


def error_feedback_update(grads: Any, residual: Any) -> Tuple[Any, Any]:
    """Add the carried residual, quantize, keep the new residual: → (the
    dequantized grads in each leaf's dtype, the new f32 residual), two
    trees of ``grads``' structure."""
    deqs, residuals = [], []

    def one(g: torch.Tensor, r: torch.Tensor) -> int:
        gf = g.to(torch.float32) + r
        deq = dequantize_int8(*quantize_int8(gf))
        deqs.append(deq.to(g.dtype))
        residuals.append(gf - deq)
        return len(deqs) - 1

    index = _tree_map(one, grads, residual)
    return (_tree_map(deqs.__getitem__, index),
            _tree_map(residuals.__getitem__, index))
