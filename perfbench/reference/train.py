"""The reference's training steps: the configuration's loss (mean cross
entropy plus the family's terms, such as a router's balance loss),
gradients by autograd, one AdamW update a step in float32, from the
weights the seed makes.

It follows the program's first steps on the same batches and reports what
the check compares: each step's loss, each leaf's gradient norm at the
first step (before clipping), and each leaf's change after the last step.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Sequence, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from .. import weights
from ..arch import Arch
from ..families import family
from .model import Prec, unembed


def lr_at(step: int, tr: Dict[str, Any]) -> float:
    """Linear warm-up to ``learning_rate`` over ``warmup_steps``, then a
    cosine down to ``lr_floor`` of it at ``total_steps``; ``step`` counts
    from 1."""
    peak, warm, total = tr["learning_rate"], tr["warmup_steps"], tr["total_steps"]
    if step < warm:
        return peak * step / max(warm, 1)
    t = min(max((step - warm) / max(total - warm, 1), 0.0), 1.0)
    floor = tr["lr_floor"]
    return peak * (floor + (1 - floor) * 0.5 * (1 + math.cos(math.pi * t)))


def _params(a: Arch, seed: int, device: Any) -> Dict[str, torch.Tensor]:
    out = {}
    for name, shape, per in weights.leaves(a):
        for layer in (range(a.n_layers) if per else [None]):
            t = weights.make(seed, name, layer, shape, device).float()
            out[weights.leaf_key(name, layer)] = t.requires_grad_(True)
    return out


def loss_of(a: Arch, p: Dict[str, torch.Tensor], tokens: torch.Tensor, labels: torch.Tensor,
            prec: Prec) -> torch.Tensor:
    """One microbatch (its rows are one call each, as the program's
    microbatch of one row is): mean cross entropy + the layers' terms
    (the family's ``block``)."""
    block = family(a.family).block
    total = torch.zeros((), device=tokens.device)
    for r in range(tokens.shape[0]):
        S = tokens.shape[1]
        pos = torch.arange(S, device=tokens.device)
        x = p["embed/table"][tokens[r]][None]
        aux = torch.zeros((), device=x.device)
        for layer in range(a.n_layers):
            w = {n: p[weights.leaf_key(n, layer)] for n, _, per in weights.leaves(a) if per}
            x, aux_l = checkpoint(block, x, w, a, pos, [(0, S, True)], prec, use_reentrant=False)
            aux = aux + aux_l
        logits = unembed(x[0], p["final_norm"], p["lm_head"], a.eps, prec)
        ce = (torch.logsumexp(logits, -1)
              - logits.gather(1, labels[r][:, None])[:, 0]).mean()
        total = total + ce + aux
    return total / tokens.shape[0]


def run(a: Arch, tr: Dict[str, Any], seed: int, batches: Sequence[Tuple[np.ndarray, np.ndarray]],
        microbatches: int, device: Any, prec: Prec) -> Dict[str, Any]:
    """len(batches) steps of the configuration's training from the seed's
    weights; row i of a batch goes to microbatch i mod ``microbatches``.
    → {"loss": [per step], "grad_norm": {leaf: first step's norm},
    "change": {leaf: norm of the change after the last step},
    "grad_norm_global": first step's}."""
    p = _params(a, seed, device)
    m = {k: torch.zeros_like(t) for k, t in p.items()}
    v = {k: torch.zeros_like(t) for k, t in p.items()}
    b1, b2, eps, wd, clip = tr["b1"], tr["b2"], tr["eps"], tr["weight_decay"], tr["grad_clip"]
    out: Dict[str, Any] = {"loss": []}
    for step, (tok, lab) in enumerate(batches, start=1):
        tok_t = torch.as_tensor(tok, device=device)
        lab_t = torch.as_tensor(lab, device=device)
        loss_sum = 0.0
        for i in range(microbatches):
            loss = loss_of(a, p, tok_t[i::microbatches], lab_t[i::microbatches], prec)
            (loss / microbatches).backward()
            loss_sum += float(loss.detach()) / microbatches
        out["loss"].append(loss_sum)
        with torch.no_grad():
            gnorm = math.sqrt(sum(float((t.grad.double() ** 2).sum()) for t in p.values()))
            if step == 1:
                out["grad_norm"] = {k: float(t.grad.norm()) for k, t in p.items()}
                out["grad_norm_global"] = gnorm
            scale = min(1.0, clip / (gnorm + 1e-9)) if clip > 0 else 1.0
            lr = lr_at(step, tr)
            bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
            for k, t in p.items():
                g = t.grad * scale
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                u = (m[k] / bc1) / (torch.sqrt(v[k] / bc2) + eps)
                t.sub_(lr * (u + wd * t))
                t.grad = None
    del m, v
    with torch.no_grad():
        change = {}
        for name, shape, per in weights.leaves(a):
            for layer in (range(a.n_layers) if per else [None]):
                k = weights.leaf_key(name, layer)
                p0 = weights.make(seed, name, layer, shape, device).float()
                change[k] = float((p[k] - p0).norm())
        out["change"] = change
    return out


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], ref_grad: Dict[str, float],
              ) -> Dict[str, float]:
    """Each leaf's |‖prog‖ − ‖ref‖| / max(‖ref‖, median leaf's ‖ref‖), over
    the leaves whose reference gradient is at least a thousandth of the
    median leaf's (those below move under Adam by rounding alone)."""
    med_g = float(np.median(list(ref_grad.values())))
    kept = [k for k in ref if ref_grad[k] >= 1e-3 * med_g]
    med = float(np.median([ref[k] for k in kept]))
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in kept}
