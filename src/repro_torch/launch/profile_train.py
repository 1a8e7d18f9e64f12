"""Where the time of a train step goes on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile_train [--config NAME] [--steps 3]

Builds one config at full width (bf16, random weights from seed 0) and the
train step that ``chip_smoke.py`` drives (``train_1k``: B=8, S=1024, two
microbatches of 4, remat "block", bf16 moments; peak learning rate 1e-3,
1e-4 for the wider configs): qwen1.5-0.5b (the
default), qwen3-moe-30b-a3b, mamba2-370m, zamba2-2.7b, phi-3-vision-4.2b
(576 patch rows before the 1024 tokens), whisper-tiny (1500 frames, 448
decoder tokens: ``train_shape``), chatglm3-6b, qwen2-7b, mixtral-8x22b or
gemma3-12b (B=4, S=2048 in two microbatches of 2), each at the depth that
``train_depth`` reckons for one card. Takes one warm-up step,
``--steps`` steps on the host clock (each ending in a synchronize), then
one step under ``torch.profiler``. Prints the depth reckoning, host ms per
step, trained tokens/s, the device's busy time in the profiled step and its
idle share against the unprofiled step time (the profiler slows the host,
not the kernels), device time by kernel family (each of the port's kernels
a family of its own: the grouped GEMM's forward, dX and dW, the SSD scan's
forward and the three kernels of its backward, ...) and by kernel, the
kernels launched per step,
and peak memory (``torch.cuda.max_memory_allocated`` over the steps).
Where the profiler records no device event, the busy time is that of one
more step between CUDA events (``kernel_times.profiled_or_events``: the
span, gaps included; the idle share and the breakdowns are then null), and
``device_time_from`` says which. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from collections import defaultdict
from typing import Any, Dict, Tuple

import numpy as np
import torch

from ..configs import get_config
from ..configs.base import ModelConfig, ShapeConfig, TrainConfig
from ..data import DataConfig, TokenPipeline, synthetic_extras
from ..kernels import ops
from ..models import build_model
from ..runtime.train import init_state, make_train_step
from .kernel_times import profiled_or_events, split_kernels

SHAPE = ShapeConfig("train_1k", 1024, 8, "train")
# whisper's decoder takes at most 448 positions (arXiv:2212.04356): it
# trains on 448 tokens against its 1500 frames. gemma3-12b trains on B=4 x
# S=2048, the same 8,192 tokens a step as the others, so that its local
# layers' window of 1024 cuts into the causal rows in the forward and the
# backward; in two microbatches of 2 (MICROBATCH)
SHAPES = {"whisper-tiny": ShapeConfig("train_448", 448, 8, "train"),
          "gemma3-12b": ShapeConfig("train_2k", 2048, 4, "train")}
TCFG = TrainConfig(remat="block", opt_dtype="bfloat16", microbatch_per_device=4,
                   warmup_steps=2, learning_rate=1e-3)
# rows a microbatch by config (TCFG's 4 for the others)
MICROBATCH = {"gemma3-12b": 2}
CONFIGS = ("qwen1.5-0.5b", "qwen3-moe-30b-a3b", "mamba2-370m", "zamba2-2.7b",
           "phi-3-vision-4.2b", "whisper-tiny", "chatglm3-6b", "qwen2-7b",
           "mixtral-8x22b", "gemma3-12b")
# train state per parameter: bf16 param 2, f32 master 4, two bf16 moments
# 4, f32 gradient accumulator 4, the step's bf16 gradient 2
STATE_BYTES_PER_PARAM = 16
# the device memory a config's train step may reach at its reckoned depth
# (of the card's 80 GB), above which it is cut further. The four 6-12 B
# configs: the state (below) plus AdamW's f32 temporaries of the largest
# leaf, about five of them alive at once (g·scale, a moment read as f32,
# the two products and their sum): chatglm3-6b's 14 stacked w_gate rows of
# 4096 x 13696 (0.79 G elements, 3.1 GB in f32), 54.2 + 15.7 GB; qwen2-7b's
# 10 of 3584 x 18944 (0.68 G), 54.7 + 13.6; mixtral-8x22b's one layer of 8
# experts of 6144 x 16384 (0.81 G), 46.5 + 16.1; gemma3-12b's embedding
# table of 262144 x 3840 (1.01 G), 53.8 + 20.1
PEAK_LIMIT_GB = {"qwen3-moe-30b-a3b": 72.0, "zamba2-2.7b": 75.0, "phi-3-vision-4.2b": 72.0,
                 "chatglm3-6b": 74.0, "qwen2-7b": 74.0, "mixtral-8x22b": 68.0,
                 "gemma3-12b": 78.0}
# layers a config trains with on one card: qwen3-moe-30b-a3b's 48 layers
# hold 623 M parameters each (10 GB of train state): 4 of them and the
# 622 M of its embedding and head, 3.11 B parameters, ~50 GB of state.
# phi-3-vision-4.2b's 32 layers hold 113 M each: all of them, 3.82 B
# parameters, would take 61 GB of state before an activation or AdamW's
# f32 temporaries of its largest leaf (0.8 G elements at full depth); 16
# of them and the 200 M of its embedding, head and patch projection come
# to 2.01 B, ~32 GB. chatglm3-6b's 28 layers hold 204.0 M each and 532.7 M
# lie outside them (its untied 65,024-row vocab): 14 layers, 3.39 B, ~54
# GB. qwen2-7b's 28 hold 233.1 M and 1,090.0 M lie outside (152,064 rows):
# 10 layers, 3.42 B, ~55 GB. mixtral-8x22b's 56 hold 2,504.1 M each (8
# experts of 6144 x 16384, three matrices) and 402.7 M lie outside: one
# layer, 2.91 B, ~46.5 GB. gemma3-12b's 48 hold 224.1 M and 2,013.3 M lie
# outside (its untied 262,144-row vocab): one 5:1 group of 6 layers (its
# depth must be a multiple of 6), 3.36 B, ~54 GB. The others train at full
# depth.
TRAIN_LAYERS = {"qwen3-moe-30b-a3b": 4, "phi-3-vision-4.2b": 16, "chatglm3-6b": 14,
                "qwen2-7b": 10, "mixtral-8x22b": 1, "gemma3-12b": 6}
# peak learning rate by config (TCFG's 1e-3 for the others): at 1e-3, two
# warm-up steps and one repeated batch, the widest configs (d 2048 and
# 2560) overshoot and their loss climbs from the third step; 1e-4 is the
# order of published rates at these sizes (GPT-3's 1.6e-4 at 2.7 B). The
# 6-12 B configs (d 3584 to 6144) overshoot there, and at 3e-5 too: their
# loss climbs at the second or third step (on the H100, at 1e-4:
# chatglm3-6b 11.56 -> 15.48, gemma3-12b 12.84 -> 14.55; at 3e-5:
# chatglm3-6b 9.25 -> 13.23, mixtral-8x22b 9.92 -> 17.50). GPT-3's own
# rates fall with width (1.2e-4 at 6.7 B, 1.0e-4 at 13 B) after thousands
# of warm-up steps, where this step warms up in two: 1e-5, at which the
# four losses fall over the 4 steps
LEARNING_RATE = {"qwen3-moe-30b-a3b": 1e-4, "mamba2-370m": 1e-4, "zamba2-2.7b": 1e-4,
                 "phi-3-vision-4.2b": 1e-4, "chatglm3-6b": 1e-5, "qwen2-7b": 1e-5,
                 "mixtral-8x22b": 1e-5, "gemma3-12b": 1e-5}
# device kernels by family: the first entry whose substrings all occur in
# the kernel's name (the grouped GEMM's backward: the bf16 dX and dW
# kernels by name, the wmma and f32 kernels' templates naming their
# operand layouts, <false, false> dX, <true, true> dW; the bf16 SSD
# backward's three kernels are "ssd_scan bwd states", "... chains" and
# "ssd_scan bwd", the last also the f32 kernel)
FAMILIES = (("moe_gmm dX", ("moe_gmm_dx_kernel",)),
            ("moe_gmm dW", ("moe_gmm_dw_kernel",)),
            ("moe_gmm dX", ("moe_gmm", "false, false>")),
            ("moe_gmm dW", ("moe_gmm", "true, true>")),
            ("moe_gmm fwd", ("moe_gmm",)),
            ("ssd_scan bwd states", ("ssd_scan_bwd_tc_states",)),
            ("ssd_scan bwd chains", ("ssd_scan_bwd_tc_chain",)),
            ("ssd_scan bwd", ("ssd_scan_bwd",)),
            ("ssd_scan fwd", ("ssd_scan",)),
            ("flash fwd", ("flash_fwd_kernel", "flash_fwd_tc_kernel", "flash_decode_kernel")),
            ("flash bwd dq", ("flash_bwd_dq",)),
            ("flash bwd dkv", ("flash_bwd_dkv",)),
            ("rmsnorm", ("rmsnorm_",)),
            ("matmul", ("gemm", "gemv", "nvjet", "cutlass", "xmma", "cublas", "splitk")),
            ("elementwise", ("elementwise", "vectorized", "reduce", "index", "copy",
                             "scatter", "gather", "cat", "softmax")))


def family(kernel_name: str) -> str:
    low = kernel_name.lower()
    for fam, keys in FAMILIES:
        if fam.startswith(("moe_gmm", "ssd_scan")):
            if all(k in low for k in keys):
                return fam
        elif any(k in low for k in keys):
            return fam
    return "other"


def train_depth(config: str) -> Tuple[ModelConfig, Dict[str, Any]]:
    """The config cut to the depth it trains at on one card, and the
    reckoning: parameters per layer and outside the layers, train state at
    ``STATE_BYTES_PER_PARAM``, and the cut."""
    full = get_config(config)
    layers = TRAIN_LAYERS.get(config, full.n_layers)
    cfg = full if layers == full.n_layers else full.scaled(n_layers=layers)
    total = build_model(cfg, "meta").n_params()
    if cfg.family == "hybrid":   # the shared block sits outside the layer count
        per_layer = None
    else:   # from two depths a whole layer pattern apart (gemma3-12b's is 6)
        unit = cfg.local_global + 1 if cfg.local_global > 0 else 1
        per_layer = (build_model(cfg.scaled(n_layers=2 * unit), "meta").n_params()
                     - build_model(cfg.scaled(n_layers=unit), "meta").n_params()) / unit
    return cfg, {
        "config": config, "layers": f"{layers} of {full.n_layers}",
        "params": total, "params_per_layer": per_layer,
        "params_outside_layers": None if per_layer is None else total - per_layer * layers,
        "state_gb": total * STATE_BYTES_PER_PARAM / 1e9,
        "cut": None if layers == full.n_layers else
        f"n_layers {full.n_layers} -> {layers}: full width, "
        f"{STATE_BYTES_PER_PARAM} bytes of train state a parameter",
        "peak_limit_gb": PEAK_LIMIT_GB.get(config)}


def train_config(config: str) -> TrainConfig:
    """TCFG at ``config``'s learning rate and microbatch."""
    return dataclasses.replace(
        TCFG, learning_rate=LEARNING_RATE.get(config, TCFG.learning_rate),
        microbatch_per_device=MICROBATCH.get(config, TCFG.microbatch_per_device))


def train_shape(config: str) -> ShapeConfig:
    """The train step's batch and sequence length: SHAPE unless SHAPES says."""
    return SHAPES.get(config, SHAPE)


def train_batch(cfg: ModelConfig, shape: ShapeConfig, seed: int, device: str):
    """Step 0's batch of the token pipeline, and a VLM's patches or an audio
    model's frames (``synthetic_extras``, f32: the model casts them), on
    ``device``."""
    batch = TokenPipeline(DataConfig(cfg.vocab, shape.seq_len, shape.global_batch,
                                     seed=seed)).batch(0)
    batch.update(synthetic_extras(cfg.family, shape.global_batch, cfg,
                                  np.random.default_rng(seed)))
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def setup(seed: int = 0, device: str = "cuda", config: str = "qwen1.5-0.5b"):
    """→ (model, train_step, state, batch) of ``config``'s train phase at
    its ``train_depth``, ``train_shape`` and ``train_config``, on ``device``."""
    cfg, _ = train_depth(config)
    model = build_model(cfg, device)
    tcfg, shape = train_config(config), train_shape(config)
    step, *_ = make_train_step(model, tcfg, shape)
    state = init_state(model, tcfg, torch.Generator(device).manual_seed(seed))
    return model, step, state, train_batch(cfg, shape, seed, device)


def main(steps: int = 3, seed: int = 0, config: str = "qwen1.5-0.5b") -> Dict[str, Any]:
    if not torch.cuda.is_available():
        raise SystemExit("profile_train needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    _, reckoning = train_depth(config)
    print(json.dumps({"depth_reckoning": reckoning}))
    model, step, state, batch = setup(seed, config=config)
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
    busy_us, by_family, by_kernel, n_kernels = split_kernels(prof, family)
    step_ms = sorted(ms)[len(ms) // 2]
    busy_us, timed_with, idle = profiled_or_events(
        busy_us, lambda: step(state, batch), "the train step", device_idle_share=step_ms / 1e3)
    traced = timed_with == "torch.profiler"
    shape = train_shape(config)
    tokens = shape.global_batch * shape.seq_len
    report = {
        "device": torch.cuda.get_device_name(0),
        "model": f"{model.cfg.name} {model.n_params() / 1e6:.1f}M params bf16, "
                 f"{reckoning['layers']} layers",
        "shape": f"B={shape.global_batch} S={shape.seq_len}, 2 microbatches, remat block",
        "step_ms": ms, "median_step_ms": step_ms,
        "trained_tok_per_s": tokens / (step_ms / 1e3),
        "device_busy_ms": busy_us / 1e3, **idle,
        "device_time_from": timed_with, "kernels_per_step": n_kernels,
        "launches_per_step": launches,
        "device_ms_by_family": {k: v / 1e3 for k, v in sorted(
            by_family.items(), key=lambda kv: -kv[1])} if traced else None,
        "top_kernels_ms": {k: v / 1e3 for k, v in sorted(
            by_kernel.items(), key=lambda kv: -kv[1])[:12]} if traced else None,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "loss": float(metrics["loss"]),
    }
    print(json.dumps(report, indent=1))
    return report


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="qwen1.5-0.5b", choices=CONFIGS)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args()
    main(a.steps, a.seed, a.config)
