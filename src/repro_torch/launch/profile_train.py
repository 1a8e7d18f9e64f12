"""Where the time of a train step goes on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile_train [--steps 3]

Builds full-width qwen1.5-0.5b (bf16, random weights from seed 0) and the
train step that ``chip_smoke.py`` drives (``train_1k``: B=8, S=1024, two
microbatches of 4, remat "block", bf16 moments), takes one warm-up step,
``--steps`` steps on the host clock (each ending in a synchronize), then
one step under ``torch.profiler``. Prints host ms per step, trained
tokens/s, the device's busy time in the profiled step and its idle share
against the unprofiled step time (the profiler slows the host, not the
kernels), device time by kernel family, the kernels launched per step, and
peak memory (``torch.cuda.max_memory_allocated`` over the steps). Needs a
CUDA card.
"""
from __future__ import annotations

import argparse
import json
import time
from collections import defaultdict
from typing import Any, Dict

import torch

from ..configs import get_config
from ..configs.base import ShapeConfig, TrainConfig
from ..data import DataConfig, TokenPipeline
from ..kernels import ops
from ..models import build_model
from ..runtime.train import init_state, make_train_step

SHAPE = ShapeConfig("train_1k", 1024, 8, "train")
TCFG = TrainConfig(remat="block", opt_dtype="bfloat16", microbatch_per_device=4,
                   warmup_steps=2, learning_rate=1e-3)
FAMILIES = (("flash fwd", ("flash_fwd_kernel", "flash_fwd_tc_kernel", "flash_decode_kernel")),
            ("flash bwd dq", ("flash_bwd_dq",)),
            ("flash bwd dkv", ("flash_bwd_dkv",)),
            ("rmsnorm", ("rmsnorm_",)),
            ("matmul", ("gemm", "gemv", "nvjet", "cutlass", "xmma", "cublas", "splitk")),
            ("elementwise", ("elementwise", "vectorized", "reduce", "index", "copy",
                             "scatter", "gather", "cat", "softmax")))


def family(kernel_name: str) -> str:
    low = kernel_name.lower()
    for fam, keys in FAMILIES:
        if any(k in low for k in keys):
            return fam
    return "other"


def setup(seed: int = 0, device: str = "cuda"):
    """→ (model, train_step, state, batch) of the train phase, on ``device``."""
    cfg = get_config("qwen1.5-0.5b")
    model = build_model(cfg, device)
    step, *_ = make_train_step(model, TCFG, SHAPE)
    state = init_state(model, TCFG, torch.Generator(device).manual_seed(seed))
    batch = TokenPipeline(DataConfig(cfg.vocab, SHAPE.seq_len, SHAPE.global_batch,
                                     seed=seed)).batch(0)
    batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    return model, step, state, batch


def main(steps: int = 3, seed: int = 0) -> Dict[str, Any]:
    if not torch.cuda.is_available():
        raise SystemExit("profile_train needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    model, step, state, batch = setup(seed)
    torch.cuda.reset_peak_memory_stats()
    state, _ = step(state, batch)                                # warm-up
    torch.cuda.synchronize()
    ms = []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    ops.reset_launch_counts()
    with torch.profiler.profile(activities=acts) as prof:
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
    launches = ops.launch_counts()
    busy_us, n_kernels = 0.0, 0
    by_family, by_kernel = defaultdict(float), defaultdict(float)
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = e.time_range.elapsed_us()
            busy_us += us
            n_kernels += 1
            by_family[family(e.name)] += us
            by_kernel[e.name[:90]] += us
    if busy_us == 0:
        raise SystemExit("the profiler recorded no device time")
    step_ms = sorted(ms)[len(ms) // 2]
    tokens = SHAPE.global_batch * SHAPE.seq_len
    report = {
        "device": torch.cuda.get_device_name(0),
        "model": f"{model.cfg.name} {model.n_params() / 1e6:.1f}M params bf16",
        "shape": f"B={SHAPE.global_batch} S={SHAPE.seq_len}, 2 microbatches, remat block",
        "step_ms": ms, "median_step_ms": step_ms,
        "trained_tok_per_s": tokens / (step_ms / 1e3),
        "device_busy_ms": busy_us / 1e3,
        "device_idle_share": 1.0 - busy_us / 1e3 / step_ms,
        "kernels_per_step": n_kernels,
        "launches_per_step": launches,
        "device_ms_by_family": {k: v / 1e3 for k, v in sorted(
            by_family.items(), key=lambda kv: -kv[1])},
        "top_kernels_ms": {k: v / 1e3 for k, v in sorted(
            by_kernel.items(), key=lambda kv: -kv[1])[:10]},
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "loss": float(metrics["loss"]),
    }
    print(json.dumps(report, indent=1))
    return report


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args()
    main(a.steps, a.seed)
