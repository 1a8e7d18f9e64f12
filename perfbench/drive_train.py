"""A training cell: one train step of ``repro_torch`` (its model, AdamW
state and microbatch loop, ``runtime.train.make_train_step``) built once,
driven from the seed through its first steps, whose readings the check
compares, then through the measured window."""
from __future__ import annotations

import gc
import time
from typing import Any, Dict

import torch

from . import probes, traffic, weights
from .arch import Arch
from .trace import Session, span, spans_on, traced_stretch


def build(a: Arch, cfg_file: Dict[str, Any], mix: Dict[str, Any], program_cfg: Any,
          seed: int, device: str):
    """→ (train_step, state, model): the program's step and its state, the
    parameters the seed's weights."""
    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import AdamW
    from repro_torch.runtime.train import make_train_step

    tr = cfg_file["train"]
    per_micro = mix["sequences_per_step"] // mix["microbatches"]
    tcfg = TrainConfig(microbatch_per_device=per_micro, remat=tr["remat"],
                       learning_rate=tr["learning_rate"], warmup_steps=tr["warmup_steps"],
                       weight_decay=tr["weight_decay"], grad_clip=tr["grad_clip"],
                       opt_dtype=tr["moments_dtype"])
    optimizer_defaults = {"b1": AdamW.b1, "b2": AdamW.b2, "eps": AdamW.eps}
    for k, v in optimizer_defaults.items():
        if v != tr[k]:
            raise SystemExit(f"the program's AdamW {k} is {v}, the configuration's {tr[k]}")
    shape = ShapeConfig("benchmark", seq_len=mix["seq_len"],
                        global_batch=mix["sequences_per_step"], kind="train")
    model = Model(program_cfg, device)
    step, *_ = make_train_step(model, tcfg, shape, total_steps=tr["total_steps"])
    params = weights.program_params(a, model.param_specs(), seed, device)
    state = {"params": params, "opt": AdamW(lr=None, mom_dtype=tcfg.opt_dtype).init(params),
             "data_step": torch.zeros((), dtype=torch.int32, device=device)}
    return step, state, model


def batch(mix: Dict[str, Any], seed: int, j: int, vocab: int, device: str):
    tok, lab = traffic.train_batch(mix, seed, j, vocab)
    return {"tokens": torch.as_tensor(tok, device=device),
            "labels": torch.as_tensor(lab, device=device)}


def first_steps(step, state, a: Arch, cfg_file: Dict[str, Any], mix: Dict[str, Any],
                seed: int, device: str):
    """The checked steps, through the window's own call and feed (batches
    0 .. checked - 1): → (state, readings: each step's loss, each leaf's
    first gradient norm as the optimizer took it, each leaf's change of
    the f32 master weights after the last)."""
    b1, clip = cfg_file["train"]["b1"], cfg_file["train"]["grad_clip"]
    prog: Dict[str, Any] = {"loss": []}
    for j in range(mix["checked_steps"]):
        state, met = step(state, batch(mix, seed, j, a.vocab, device))
        prog["loss"].append(float(met["loss"]))
        if j == 0:
            # from the first moment: m = (1 - b1) · g · min(1, clip / ‖g‖)
            gnorm = float(met["grad_norm"])
            scale = min(1.0, clip / (gnorm + 1e-9)) if clip > 0 else 1.0
            prog["grad_norm_global"] = gnorm
            prog["grad_norm"] = {k: float(t.float().norm()) / (1 - b1) / scale
                                 for k, t in weights.program_leaf_views(state["opt"].m, a).items()}
    master = weights.program_leaf_views(state["opt"].master, a)
    prog["change"] = {}
    for name, shape, per in weights.leaves(a):
        for layer in (range(a.n_layers) if per else [None]):
            k = weights.leaf_key(name, layer)
            p0 = weights.make(seed, name, layer, shape, device).float()
            prog["change"][k] = float((master[k] - p0).norm())
    return state, prog


def run(a: Arch, cfg_file: Dict[str, Any], mix: Dict[str, Any], program_cfg: Any, seed: int,
        seconds: float, trace: bool, device: str, on_window_open) -> Dict[str, Any]:
    from repro_torch.kernels import ops
    from repro_torch.optim.adamw import AdamW

    step, state, model = build(a, cfg_file, mix, program_cfg, seed, device)
    state, prog = first_steps(step, state, a, cfg_file, mix, seed, device)
    checked = mix["checked_steps"]
    tokens_per_step = mix["sequences_per_step"] * mix["seq_len"]

    session = Session(device) if trace else None
    opens, closes = traced_stretch(seconds)
    targets = [(model, "loss", "train.forward"), (AdamW, "update", "train.optimizer"),
               (torch.autograd, "grad", "train.backward")]
    ops.reset_launch_counts()
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    steps = []
    j = checked
    on_window_open()
    t0 = time.perf_counter()
    with spans_on(session, targets):
        while True:
            if session and session.prof is None and time.perf_counter() - t0 >= opens:
                session.open()
            s = time.perf_counter()
            with span(session, "train.step"):
                state, met = step(state, batch(mix, seed, j, a.vocab, device))
                float(met["loss"])
            e = time.perf_counter()
            steps.append({"start": s - t0, "end": e - t0, "tokens": tokens_per_step})
            j += 1
            if session and session.is_open and e - t0 >= closes:
                session.close()
            if e - t0 >= seconds:
                break
    if session and session.is_open:
        session.close()
    launches = ops.launch_counts()
    rec: Dict[str, Any] = {
        "kind": "train", "seconds": seconds, "steps": steps, "checked": prog,
        "attempted": checked + len(steps), "failed": 0,
        "launches_per_step": {k: v / len(steps) for k, v in launches.items()},
    }
    if device == "cuda":
        rec["peak_window_bytes"] = torch.cuda.max_memory_allocated()
    del state, step, model, met
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    if session:
        rec["trace"] = session.read()
        if device == "cuda":
            rec["probes"] = probes.timed(a, mix, "train")
    return rec
