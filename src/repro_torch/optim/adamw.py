"""AdamW (port of ``repro.optim.adamw``): f32 master weights, moments in
``mom_dtype``, working params cast from the master, global-norm clipping,
warmup + cosine schedule.

Parameters, master and moments are nested dicts of tensors on ``repro``'s
key paths. The arithmetic follows ``repro`` line by line: the moments are
updated in f32 and rounded to ``mom_dtype`` once per step, bias correction
counts ``step`` after the increment, the clip factor is
``min(1, clip / (gnorm + 1e-9))``, and weight decay is decoupled,
``p32 - lr * (u + wd * p32)``. Unlike ``repro``'s pure update, ``update``
writes the new master, moments and params **in place** into the tensors it
is given: that saves a second copy of all four (~4.6 GB at qwen1.5-0.5b's
full width). ``torch.optim.AdamW`` is not used: it keeps no f32 master
beside bf16 params and no bf16 moments.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, NamedTuple, Tuple

import torch

_MOM_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class AdamWState(NamedTuple):
    step: torch.Tensor              # () int32
    master: Any                     # f32 copy of params
    m: Any
    v: Any


def tree_leaves(tree: Any) -> List[torch.Tensor]:
    """The tensors of a nested dict, in sorted key order."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn: Callable[[torch.Tensor], torch.Tensor], tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


@dataclass(frozen=True)
class AdamW:
    lr: Callable[[torch.Tensor], torch.Tensor]
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    mom_dtype: str = "float32"

    def init(self, params: Any) -> AdamWState:
        mdt = _MOM_DTYPES[self.mom_dtype]
        leaf = tree_leaves(params)[0]
        return AdamWState(
            torch.zeros((), dtype=torch.int32, device=leaf.device),
            tree_map(lambda p: p.detach().to(torch.float32, copy=True), params),
            tree_map(lambda p: torch.zeros(p.shape, dtype=mdt, device=p.device), params),
            tree_map(lambda p: torch.zeros(p.shape, dtype=mdt, device=p.device), params))

    @torch.no_grad()
    def update(self, grads: Any, state: AdamWState, params: Any,
               ) -> Tuple[Any, AdamWState, Dict[str, torch.Tensor]]:
        """→ (params, state, {"grad_norm", "lr"}); ``params`` and the state's
        master and moments are updated in place and returned."""
        step = state.step + 1
        g32 = [g.float() for g in tree_leaves(grads)]
        gnorm = global_norm(g32)
        if self.grad_clip > 0:
            scale = torch.clamp(self.grad_clip / (gnorm + 1e-9), max=1.0)
        else:
            scale = torch.ones((), dtype=torch.float32, device=gnorm.device)
        b1, b2 = self.b1, self.b2
        f32 = torch.float32
        stepf = step.to(f32)
        bc1 = 1 - torch.tensor(b1, dtype=f32, device=stepf.device) ** stepf
        bc2 = 1 - torch.tensor(b2, dtype=f32, device=stepf.device) ** stepf
        lr = self.lr(step)
        for g, p32, m, v, p in zip(g32, tree_leaves(state.master), tree_leaves(state.m),
                                   tree_leaves(state.v), tree_leaves(params)):
            g = g * scale
            m.copy_(b1 * m.float() + (1 - b1) * g)       # one rounding to mom dtype
            v.copy_(b2 * v.float() + (1 - b2) * g * g)
            u = (m.float() / bc1) / (torch.sqrt(v.float() / bc2) + self.eps)
            p32.sub_(lr * (u + self.weight_decay * p32))
            p.copy_(p32)
        return params, AdamWState(step, state.master, state.m, state.v), {
            "grad_norm": gnorm, "lr": lr}


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32."""
    leaves = tree if isinstance(tree, list) else tree_leaves(tree)
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in leaves))


def warmup_cosine(peak_lr: float, warmup: int, total: int,
                  floor: float = 0.1) -> Callable[[torch.Tensor], torch.Tensor]:
    def lr(step: torch.Tensor) -> torch.Tensor:
        s = torch.as_tensor(step).to(torch.float32)
        warm = peak_lr * s / max(warmup, 1)
        t = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * t)))
        return torch.where(s < warmup, warm, cos)

    return lr
