"""Train launch (port of ``repro.launch.train``): CWS-orchestrated,
checkpointed, resumable, on the card.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \
        --steps 60 --chunk 10 --ckpt-dir ckpt
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --smoke \
        --steps 8 --chunk 2 --ckpt-dir ckpt --ckpt-every 4
    # kill it any time; rerun the same command → resumes from the last
    # committed checkpoint with the same data order.

``--preset 100m`` trains a ~100M-param dense model of the arch's family.
The training job is compiled into a workflow DAG and scheduled through the
CWSI (step chunks, then checkpoint tasks), so restarts, provenance and
runtime prediction all come from the CWS. Checkpoints are ``repro``'s
on-disk format: a run resumes from ``repro``'s checkpoints and ``repro``
from its. It runs on ``cuda`` unless ``--device cpu`` is given; on the card
the kernels are built before the workflow starts.

The CWS runs a checkpoint task beside the next chunk (both depend only on
the chunk before them), and the step updates the state in place. So the
chunk that ends on a checkpoint step copies the state to host memory
before it returns, and the checkpoint task writes that copy.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, List, Optional

import torch

from ..checkpoint import host_copy, latest_checkpoint, restore_checkpoint, save_checkpoint
from ..configs import get_config
from ..configs.base import ShapeConfig, TrainConfig
from ..data import DataConfig, TokenPipeline
from ..kernels import build, ops
from ..models import build_model
from ..runtime.orchestrator import (
    LocalRuntime,
    SharedState,
    TrainJobSpec,
    build_training_workflow,
)
from ..runtime.train import init_state, make_train_step


def preset_100m(cfg):
    """~100M-param dense config of the same family (full driver target)."""
    return cfg.scaled(n_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
                      d_ff=3072, vocab=32768)


def train(arch: str = "qwen1.5-0.5b", smoke: bool = False, preset: str = "none",
          steps: int = 60, chunk: int = 10, batch: int = 8, seq: int = 128,
          lr: float = 3e-3, ckpt_dir: str = "", ckpt_every: int = 20,
          strategy: str = "rank_min_rr", seed: int = 0,
          device: Optional[str] = None) -> Dict[str, Any]:
    """Train as ``main`` does and return what the run did: ``steps`` (per
    step: loss, grad norm, host seconds ending in a synchronising read
    of the loss, and the kernels' launch counts after it), ``chunks`` (the
    workflow's chunk outputs), ``checkpoints`` (per written step: seconds
    of the host copy and of the write), ``start_step``, ``resumed_from``,
    the final ``state``, the ``workflow`` and the (shut down) ``runtime``,
    whose CWS holds the provenance and the predictors."""
    cfg = get_config(arch, smoke=smoke)
    if preset == "100m":
        cfg = preset_100m(cfg)
    model = build_model(cfg, device)
    print(f"[train] arch={cfg.name} params={model.n_params():,}")

    shape = ShapeConfig("driver", seq, batch, "train")
    tcfg = TrainConfig(learning_rate=lr, warmup_steps=10,
                       microbatch_per_device=batch)
    step, _, _, state_specs = make_train_step(model, tcfg, shape,
                                              total_steps=steps)
    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                    global_batch=batch, seed=seed))
    if model.device.type == "cuda":
        build.library()             # no compile inside a task

    start_step = 0
    ck = latest_checkpoint(ckpt_dir) if ckpt_dir else None
    if ck:
        state, manifest = restore_checkpoint(ck, state_specs, device=model.device)
        start_step = int(manifest["step"])
        print(f"[train] resumed from {ck} at step {start_step}")
    else:
        state = init_state(model, tcfg,
                           torch.Generator(model.device).manual_seed(seed),
                           total_steps=steps)

    shared = SharedState(state)
    ckpt_every = ckpt_every if ckpt_dir else 0
    per_step: List[Dict[str, Any]] = []
    snapshots: Dict[int, Any] = {}
    ckpt_times: Dict[int, Dict[str, float]] = {}

    def run_chunk(sh: SharedState, start: int, stop: int):
        for s in range(start, stop):
            t0 = time.perf_counter()
            b = {k: torch.from_numpy(v).to(model.device)
                 for k, v in pipe.batch(s).items()}
            sh.state, m = step(sh.state, b)
            loss = float(m["loss"])
            per_step.append({"step": s + 1, "loss": loss,
                             "grad_norm": float(m["grad_norm"]),
                             "seconds": time.perf_counter() - t0,
                             "launches": ops.launch_counts()})
        print(f"[train] step {stop:5d} loss {loss:.4f} "
              f"lr {float(m['lr']):.2e} gnorm {float(m['grad_norm']):.2f}")
        # the workflow's rule for a checkpoint task after this chunk
        if ckpt_every and (stop - start_step) % ckpt_every == 0:
            t0 = time.perf_counter()
            snapshots[stop] = host_copy(sh.state)
            ckpt_times[stop] = {"copy_s": time.perf_counter() - t0}
        return {"step": stop, "loss": loss}

    def run_ckpt(sh: SharedState, step_no: int):
        t0 = time.perf_counter()
        save_checkpoint(ckpt_dir, step_no, snapshots.pop(step_no),
                        {"arch": cfg.name})
        ckpt_times[step_no]["write_s"] = time.perf_counter() - t0
        print(f"[train] checkpoint @ {step_no}")

    spec = TrainJobSpec(job_id=f"train-{cfg.name}",
                        n_steps=steps - start_step,
                        chunk=chunk,
                        ckpt_every=ckpt_every)

    def chunk_with_offset(sh, a, b):
        return run_chunk(sh, a + start_step, b + start_step)

    def ckpt_with_offset(sh, s):
        return run_ckpt(sh, s + start_step)

    dag = build_training_workflow(
        spec, chunk_with_offset, shared,
        run_ckpt=ckpt_with_offset if ckpt_dir else None)
    rt = LocalRuntime(n_nodes=1, strategy=strategy)
    try:
        rt.run(dag, timeout_s=6000)
    finally:
        rt.shutdown()
    losses = [m["loss"] for m in shared.metrics if "loss" in m]
    if losses:
        print(f"[train] done: first-chunk loss {losses[0]:.3f} → "
              f"last-chunk loss {losses[-1]:.3f}")
    # the workflow's tasks keep ``shared``: hand the state over, not a copy
    state, shared.state = shared.state, None
    return {"start_step": start_step, "resumed_from": ck,
            "steps": per_step, "chunks": list(shared.metrics),
            "checkpoints": ckpt_times, "state": state,
            "workflow": dag, "runtime": rt}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--preset", choices=["none", "100m"], default="none")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--chunk", type=int, default=10)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--strategy", default="rank_min_rr")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="torch device (default cuda)")
    train(**vars(ap.parse_args()))


if __name__ == "__main__":
    main()
