"""Train-step factory (port of ``repro.runtime.train``), one card.

Composes microbatched gradient accumulation, remat (inside the model's
layer-group loop), and AdamW with f32 master weights. ``make_train_step``
and ``init_state`` keep ``repro``'s names and return shapes; the mesh and
the sharding arguments exist for that and take only ``None`` (one device)
until the sharding slice, which brings ZeRO-1/2 and the multi-pod axis.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from ..configs.base import ShapeConfig, TrainConfig
from ..models.model import Model
from ..optim.adamw import AdamW, AdamWState, tree_leaves, tree_map, warmup_cosine

_SHARDING_SLICE = ("meshes and sharding come with the sharding slice "
                   "(runtime/sharding.py); on one card pass mesh=None")


def _one_device(mesh: Any, multi_pod: bool) -> None:
    if mesh is not None or multi_pod:
        raise NotImplementedError(_SHARDING_SLICE)


def n_microbatches(shape: ShapeConfig, mesh: Any, tcfg: TrainConfig,
                   multi_pod: bool = False) -> int:
    _one_device(mesh, multi_pod)
    return max(1, shape.global_batch // max(tcfg.microbatch_per_device, 1))


def _optimizer(tcfg: TrainConfig, total_steps: int) -> AdamW:
    return AdamW(lr=warmup_cosine(tcfg.learning_rate, tcfg.warmup_steps, total_steps),
                 weight_decay=tcfg.weight_decay, grad_clip=tcfg.grad_clip,
                 mom_dtype=tcfg.opt_dtype)


def make_train_step(model: Model, tcfg: TrainConfig, shape: ShapeConfig,
                    mesh: Any = None, multi_pod: bool = False,
                    total_steps: int = 10_000,
                    ) -> Tuple[Callable, None, None, Dict[str, Any]]:
    """→ (train_step, state_shardings, batch_shardings, state_specs).

    ``train_step(state, batch) -> (state, metrics)``: row i of the batch
    goes to microbatch i mod n, as ``repro`` splits it; each microbatch's
    gradients (``torch.autograd.grad`` on leaves made to require grad here,
    sharing the params' storage) accumulate in f32 as ``g / n``, the loss as
    ``loss / n``; then one AdamW update, in place. Metrics: ``loss``, ``ce``
    (mean over microbatches), ``grad_norm``, ``lr``. The shardings are
    ``None`` on one card; ``state_specs`` is the state's tree on the
    ``meta`` device."""
    _one_device(mesh, multi_pod)
    opt = _optimizer(tcfg, total_steps)
    n_micro = n_microbatches(shape, mesh, tcfg, multi_pod)
    p_specs = model.param_specs()
    mdt = torch.bfloat16 if tcfg.opt_dtype == "bfloat16" else torch.float32
    meta = lambda dt: tree_map(  # noqa: E731
        lambda s: torch.empty(s.shape, dtype=dt, device="meta"), p_specs)
    scalar = torch.empty((), dtype=torch.int32, device="meta")
    state_specs = {"params": p_specs,
                   "opt": AdamWState(scalar, meta(torch.float32), meta(mdt), meta(mdt)),
                   "data_step": scalar}

    def train_step(state: Dict[str, Any], batch: Dict[str, torch.Tensor],
                   ) -> Tuple[Dict[str, Any], Dict[str, torch.Tensor]]:
        params = state["params"]
        acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device), params)
        loss_sum = torch.zeros((), dtype=torch.float32, device=state["data_step"].device)
        ces = []
        for i in range(n_micro):
            mb = {k: v[i::n_micro] for k, v in batch.items()}
            with torch.enable_grad():
                leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
                loss, metrics = model.loss(leaves, mb, tcfg.remat)
                grads = torch.autograd.grad(loss, tree_leaves(leaves))
            for a, g in zip(tree_leaves(acc), grads):
                a.add_(g.float() / n_micro)
            loss_sum += loss.detach() / n_micro
            ces.append(metrics["ce"].detach())
            del leaves, loss, metrics, grads
        new_params, new_opt, opt_metrics = opt.update(acc, state["opt"], params)
        out_metrics = {"loss": loss_sum, "ce": torch.stack(ces).mean(), **opt_metrics}
        return {"params": new_params, "opt": new_opt,
                "data_step": state["data_step"] + 1}, out_metrics

    return train_step, None, None, state_specs


def init_state(model: Model, tcfg: TrainConfig, rng: torch.Generator,
               total_steps: int = 10_000) -> Dict[str, Any]:
    """Params from ``rng`` (a generator on the model's device), AdamW state,
    ``data_step`` 0. ``repro``'s ``init_state`` builds its AdamW without
    ``mom_dtype``, so its moments start in f32 and become ``opt_dtype``
    after the first step; here they are in ``tcfg.opt_dtype`` from the
    start. The numbers are the same: zeros round exactly."""
    params = model.init(rng)
    return {"params": params, "opt": _optimizer(tcfg, total_steps).init(params),
            "data_step": torch.zeros((), dtype=torch.int32, device=model.device)}
