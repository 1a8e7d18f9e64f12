"""Train-step factory (port of ``repro.runtime.train``), on one card or on
a device mesh.

Composes microbatched gradient accumulation, remat (inside the model's
layer-group loop), AdamW with f32 master weights, ZeRO-1 optimizer-state
sharding (an extra data-axis assignment per state tensor) and ZeRO-2
gradient accumulators (accumulated in the optimizer's sharding). On a
mesh the state and the batch are DTensors placed by ``repro``'s rules
(``runtime.sharding``) and the step runs the same model code on them;
``mesh=None`` is the one-device path, on plain tensors.
"""
from __future__ import annotations

import contextlib
import itertools
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor import zeros as dtensor_zeros
from torch.distributed.tensor.experimental import implicit_replication

from ..configs.base import ShapeConfig, TrainConfig
from ..models.model import Model
from ..optim.adamw import AdamW, AdamWState, tree_leaves, tree_map, warmup_cosine
from ..spans import span
from .sharding import (
    NamedSharding,
    Rules,
    axis_sizes,
    batch_axes,
    input_axes,
    map_tree,
    replicated,
    shardings_for_tree,
    spec_for,
    train_rules,
)


def dp_size(mesh: Any, multi_pod: bool) -> int:
    """The extent of the batch axes (1 without a mesh)."""
    if mesh is None:
        return 1
    n = 1
    sizes = axis_sizes(mesh)
    for ax in batch_axes(multi_pod):
        n *= sizes.get(ax, 1)
    return n


def n_microbatches(shape: ShapeConfig, mesh: Any, tcfg: TrainConfig,
                   multi_pod: bool = False) -> int:
    per_dev = shape.global_batch // dp_size(mesh, multi_pod)
    return max(1, per_dev // max(tcfg.microbatch_per_device, 1))


def _optimizer(tcfg: TrainConfig, total_steps: int) -> AdamW:
    return AdamW(lr=warmup_cosine(tcfg.learning_rate, tcfg.warmup_steps, total_steps),
                 weight_decay=tcfg.weight_decay, grad_clip=tcfg.grad_clip,
                 mom_dtype=tcfg.opt_dtype)


def mesh_context(mesh: Any) -> contextlib.AbstractContextManager:
    """What a step on ``mesh`` runs under: plain tensors made inside the
    model (positions, RoPE tables, masks, the optimizer's constants) take
    part in DTensor ops as replicated values. Nothing without a mesh."""
    return implicit_replication() if mesh is not None else contextlib.nullcontext()


def local_rows(x: torch.Tensor, i: int, n: int) -> torch.Tensor:
    """Rows ``i::n`` of a batch tensor, keeping its placements: each rank
    takes rows ``i::n`` of its own shard, which is rows ``i::n`` of the
    whole batch when every shard's row count divides by n."""
    if not isinstance(x, DTensor):
        return x[i::n]
    local = x.to_local()
    if local.shape[0] % n:
        raise ValueError(f"a batch shard of {local.shape[0]} rows does not split "
                         f"into {n} microbatches")
    return DTensor.from_local(local[i::n], x.device_mesh, x.placements, run_check=False)


def _zeros(p: torch.Tensor, sh: Optional[NamedSharding]) -> torch.Tensor:
    if sh is None:
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return dtensor_zeros(p.shape, dtype=torch.float32, device_mesh=sh.mesh,
                         placements=sh.placements)


def _full(t: torch.Tensor) -> torch.Tensor:
    return t.full_tensor() if isinstance(t, DTensor) else t


def make_train_step(model: Model, tcfg: TrainConfig, shape: ShapeConfig,
                    mesh: Any = None, multi_pod: bool = False,
                    total_steps: int = 10_000,
                    ) -> Tuple[Callable, Any, Any, Dict[str, Any]]:
    """→ (train_step, state_shardings, batch_shardings, state_specs).

    ``train_step(state, batch) -> (state, metrics)``: row i of the batch
    goes to microbatch i mod n, as ``repro`` splits it; each microbatch's
    gradients (``torch.autograd.grad`` on leaves made to require grad here,
    sharing the params' storage) accumulate in f32 as ``g / n``, the loss as
    ``loss / n``; then one AdamW update, in place. Metrics (plain tensors):
    ``loss``, ``ce`` (mean over microbatches), ``grad_norm``, ``lr``.

    With a ``DeviceMesh`` the shardings are trees of ``NamedSharding``:
    params by ``train_rules``, the AdamW state by ``_zero1_shardings``, the
    f32 accumulators in the optimizer's sharding when ``tcfg.zero2`` (else
    in the params'), the batch by ``input_axes``; the state and batch given
    to the step must be placed so (``sharding.shard_tree``). Without a mesh
    they are ``None``. ``state_specs`` is the state's tree on ``meta``."""
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

    state_sh = batch_sh = grad_sh = None
    if mesh is not None:
        rules = train_rules(multi_pod, model.cfg.family)
        p_axes = model.param_axes()
        param_sh = shardings_for_tree(p_specs, p_axes, rules, mesh)
        opt_sh = _zero1_shardings(p_specs, p_axes, rules, mesh, enable=tcfg.zero1)
        state_sh = {"params": param_sh,
                    "opt": AdamWState(replicated(mesh), opt_sh, opt_sh, opt_sh),
                    "data_step": replicated(mesh)}
        batch_sh = shardings_for_tree(model.input_specs(shape),
                                      input_axes(model.cfg, "train"), rules, mesh)
        # ZeRO-2: accumulate in the optimizer's sharding, so each device
        # holds its update shard and each microbatch's gradients are
        # reduce-scattered into it
        grad_sh = opt_sh if tcfg.zero2 else param_sh

    calls = itertools.count()

    def train_step(state: Dict[str, Any], batch: Dict[str, torch.Tensor],
                   ) -> Tuple[Dict[str, Any], Dict[str, torch.Tensor]]:
        n = next(calls)
        dev = _full(state["data_step"]).device
        with mesh_context(mesh), span("train_step", key=n, device=dev):
            params = state["params"]
            acc = (tree_map(lambda p: _zeros(p, None), params) if grad_sh is None
                   else map_tree(_zeros, params, grad_sh))
            loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
            ces = []
            for i in range(n_micro):
                mb = {k: local_rows(v, i, n_micro) for k, v in batch.items()}
                with torch.enable_grad():
                    leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
                    with span("train_step.forward", key=n, device=dev, microbatch=i):
                        loss, metrics = model.loss(leaves, mb, tcfg.remat)
                    with span("train_step.backward", key=n, device=dev, microbatch=i):
                        grads = torch.autograd.grad(loss, tree_leaves(leaves))
                with span("train_step.accumulate", key=n, device=dev, microbatch=i):
                    for a, g in zip(tree_leaves(acc), grads):
                        a.add_(g.float() / n_micro)     # reduce-scatter into a ZeRO-2 shard
                loss_sum += _full(loss.detach()) / n_micro
                ces.append(_full(metrics["ce"].detach()))
                del leaves, loss, metrics, grads
            with span("train_step.optimizer", key=n, device=dev):
                new_params, new_opt, opt_metrics = opt.update(acc, state["opt"], params)
            out_metrics = {"loss": loss_sum, "ce": torch.stack(ces).mean(),
                           **{k: _full(v) for k, v in opt_metrics.items()}}
            return {"params": new_params, "opt": new_opt,
                    "data_step": state["data_step"] + 1}, out_metrics

    return train_step, state_sh, batch_sh, state_specs


def _zero1_shardings(p_specs: Any, p_axes: Any, rules: Rules, mesh: Any,
                     enable: bool = True) -> Any:
    """Optimizer-state shardings: the param spec + one extra data-axis
    assignment on the first unsharded divisible dim (ZeRO-1)."""
    data_n = axis_sizes(mesh).get("data", 1)

    def one(s: torch.Tensor, ax: Tuple) -> NamedSharding:
        spec = list(spec_for(s.shape, ax, rules, mesh))
        spec += [None] * (len(s.shape) - len(spec))
        if enable and data_n > 1:
            used = {a for e in spec if e
                    for a in (e if isinstance(e, tuple) else (e,))}
            if "data" not in used:
                for i, (size, cur) in enumerate(zip(s.shape, spec)):
                    if cur is None and size % data_n == 0:
                        spec[i] = "data"
                        break
        return NamedSharding.of(mesh, spec)

    return map_tree(one, p_specs, p_axes)


def init_state(model: Model, tcfg: TrainConfig, rng: torch.Generator,
               total_steps: int = 10_000) -> Dict[str, Any]:
    """Params from ``rng`` (a generator on the model's device), AdamW state,
    ``data_step`` 0, all plain tensors (``sharding.shard_tree`` places them
    on a mesh). ``repro``'s ``init_state`` builds its AdamW without
    ``mom_dtype``, so its moments start in f32 and become ``opt_dtype``
    after the first step; here they are in ``tcfg.opt_dtype`` from the
    start. The numbers are the same: zeros round exactly."""
    params = model.init(rng)
    return {"params": params, "opt": _optimizer(tcfg, total_steps).init(params),
            "data_step": torch.zeros((), dtype=torch.int32, device=model.device)}
