#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) if it fails:
  1. device  — a CUDA card is required (there is no CPU fallback); prints the
               card's name and power limit; TF32 off for matmul and cuDNN.
  2. build   — compiles the kernels from ``src/repro_torch/kernels/csrc``.
  3. kernels — each kernel against its plain PyTorch version on the card, at
               the JAX test shapes and at the main paths' shapes (RMSNorm
               also at d no multiple of 8 under each row mapping; the
               grouped expert GEMM also at ragged C = 1, 8, 17, 40, 256,
               320 and a D/F of no tile's width, its launches by variant
               checked (bf16 C > 16 all on the tensor-core kernel); the SSD
               scan, y and final state, also at ragged S = 1, 37, 257,
               300, at the bf16 kernel's chunk edges (S = 1, 127, 128, 129,
               257), G = 2 and 4 with several heads a group, every state
               dim, P = 32, 64, 128, strided xBC views and strong decay,
               its launches by variant checked (bf16 all on the
               tensor-core kernel, f32 on FMA); the flash forward's three
               variants (tensor-core prefill, split-KV decode, f32 FMA)
               at ragged S, decode kv_len at chunk edges, GQA 1:1 to 8:1,
               windows, every D
               (32, 64, 80, 96, 128, 256), strided q/k/v and cache views,
               in f32 and bf16, with the launches by variant checked and a
               misaligned view refused; the backward's two variants
               (tensor-core for bf16, FMA for f32) at every D with ragged
               S, windows and GQA up to 8:1, and at four timed shapes: the
               train step's, qwen3-moe's 32/4 heads of 128, zamba2's 32
               of 80, gemma3's 16/8 of 256 with its window); takes
               the device time (``torch.profiler``) of the kernel, of the
               plain version and of one PyTorch library call of the same
               function where there is one (a yardstick only: the port never
               calls it; no PyTorch call computes an SSD scan), and
               the kernel's call time through its wrapper. The backward
               kernels take O and lse from the forward kernel. The
               grouped GEMM's backward (dX = dy·wᵀ, dW = bufᵀ·dy) in f32
               and bf16 at C = 1, 8, 17, 40, 320, with D or F no multiple
               of 8 and a misaligned base (the wmma tile), its launches by
               variant checked, timed at the MoE train microbatch (gate/up
               and down, C = 320) beside ``torch.bmm``; the SSD backward
               (dxh, ddt, da, dB, dC) in f32 (``fma``) and bf16 (``tc``)
               at ragged S (1 to 300, the 64-row tile's and the 128-row
               chunk's edges), G = 1, 2, 4, every state dim, P = 32, 64,
               128, strided views, strong decay, dh_final zero and not,
               each output within TOL relative and of its largest value
               and per 64-row tile of ``ssd_scan_bwd_plain``, the bf16
               kernel also within TC_PLAIN_TOL of its own arithmetic
               (``ssd_scan_bwd_tc_plain``), its launches by variant
               checked, both variants timed (``tc`` whole and by its three
               kernels) at mamba2-370m's and zamba2-2.7b's train
               microbatch.
  4. serve   — full-width qwen1.5-0.5b (bf16, random weights from seed 0):
               ``make_prefill_step`` at B=4, S=1024, then 16 requests through
               ``ContinuousBatcher(batch_slots=8, max_len=2048)`` in
               shortest-predicted-first order (``launch.serve_workload``).
               The forward kernels' launch counters must grow over this
               main path and split into equal prefills and equal decode
               rounds of the counts its layers give (flash_fwd 24, rmsnorm
               49), the prefills' attention all on the tensor-core
               variant, the rounds' on the split-KV one, none on the FMA
               one; two requests' first-token logits must match the same
               requests served alone (guard against cross-slot KV writes).
  5. train   — the same model trained 4 steps on one batch
               (``launch.profile_train.setup``: B=8, S=1024, two microbatches,
               remat "block", bf16 moments). Losses and grad norms must be
               finite, the last loss below the first, and all four kernels'
               launch counters must grow and split into equal steps of the
               counts remat over 24 layers and 2 microbatches gives
               (flash_fwd 96, flash_bwd_dq 48, flash_bwd_dkv 48, rmsnorm 194),
               every forward and backward attention launch on the
               tensor-core variants, and no MoE or SSM kernel (forward or
               backward) launched.
  6. train through the CWS — after phase 5's memory is given back, the
               same model at full width and depth through the train launch
               (``launch.train.train``: B=8, S=1024 in one microbatch, 8
               steps in chunks of 2, a checkpoint task every 4 steps, lr
               1e-3), a workflow the CWS schedules on its worker threads
               (run A); then ``step_00000008`` deleted, as after a crash
               past step 4, and the same arguments again (run B), which
               must resume at step 4 and retake steps 5-8. Fails if the
               checkpoints' disk has under CKPT_MIN_FREE_GB free, a loss
               is not finite or run A's last is not below its first, a task
               of either workflow did not succeed on its first attempt, a
               step's launches are not the counts remat over 24 layers and
               one microbatch gives (flash_fwd 48, flash_bwd_dq 24,
               flash_bwd_dkv 24, rmsnorm 97; no other kernel) with every
               attention launch on the tensor-core variants,
               ``step_00000004`` does not hold step 4's state (its
               ``data_step`` and optimizer step 4, its params the bf16 of
               its master), or run B's losses are farther than RESUME_TOL
               from run A's. Prints each checkpoint's seconds, the CWS's
               provenance (task, node, runtime), the Lotaru estimate for a
               ``train_chunk``, peak memory, steps/s and trained tokens/s,
               the max |Δloss| of the resumed steps and whether they are
               bit-identical.
  7. serve SSM — after the earlier phases' memory is given back, phase 4 on
               full-width, full-depth mamba2-370m (48 layers, 419.8 M
               parameters), then on zamba2-2.7b (54 Mamba layers and one
               shared attention block applied 9 times, 2.42 B parameters),
               bf16 from seed 0. Per prefill and per decode round:
               mamba2 ssd_scan 48 / 0 and rmsnorm 97 / 97, no attention;
               zamba2 ssd_scan 54 / 0, rmsnorm 127 / 127, flash_fwd 9 / 9;
               every SSD launch on the tensor-core kernel.
               A kernel that runs only in prefills passes the split check,
               one that never runs fails it. The cross-slot guard, and a
               state guard: a 300-token prompt admitted by one prefill (the
               kernel's final state) against the same prompt fed token by
               token through ``decode_step``, first-token logits compared
               in f32 (within GUARD_TOL) and in bf16 (against the f32
               result: the prefill no farther off than the feed).
  8. serve MoE — after the earlier phases' memory is given back, phase 4 on
               full-width, full-depth qwen3-moe-30b-a3b (48 layers, 128
               experts top-8, 30.5 B parameters in bf16 from seed 0): per
               prefill and per decode round flash_fwd 48, rmsnorm 97 and
               moe_gmm 144 launches, no backward launch; every prefill's
               moe_gmm launch (C > 16) on the tensor-core variant, every
               decode round's (C = 8) on the decode one; the cross-slot guard.
  9. serve gemma3 — after the earlier phases' memory is given back, phase 4
               on full-width, full-depth gemma3-12b (48 layers, 5 local
               layers of window 1024 to 1 global, 16 query and 8 KV heads of
               256, 12.77 B parameters in bf16 from seed 0): per prefill and
               per decode round flash_fwd 48 and rmsnorm 97 launches; the
               cross-slot guard.
 10. train MoE, SSM, hybrid — after the earlier phases' memory is given
               back, phase 5 on qwen3-moe-30b-a3b (full width, 4 of 48
               layers: 3.11 B parameters, ~50 GB of train state at 16
               bytes a parameter; the peak must stay within 72 GB), then
               full-width, full-depth mamba2-370m and zamba2-2.7b (the
               peak within 75 GB), each through
               ``profile_train.setup(config=...)``. Per step, from remat
               over L layers and 2 microbatches: MoE moe_gmm 12·L,
               moe_gmm_dx 6·L, moe_gmm_dw 6·L and the flash kernels as the
               dense step; mamba2 ssd_scan 4·48, ssd_scan_bwd 2·48, no
               attention; zamba2 as mamba2 over its 54 Mamba layers plus
               the shared block's 9 flash launches each way. Every bf16
               forward gmm launch on ``tc_prefill``, every SSD forward and
               backward on ``tc``, every other backward on its tensor-core
               kernel; step time and
               peak memory printed. Before each, a gradient guard: one
               microbatch's loss gradients through the kernels against the
               same through the plain versions of the grouped GEMM and the
               SSD scan on the card, within GRAD_F32_TOL of their norm in
               f32 and, in bf16, no farther from the f32 result than the
               plain versions' plus GUARD_TOL.
 11. report  — the card's nvidia-smi line, one JSON line with every kernel's
               launches, error, times and bound, then
               ``{"ok": true, "device": {...}}`` as the last line.
"""
from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet, dense): the bound of each kernel
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
TOL = {"float32": 2e-3, "bfloat16": 2e-2}        # tests/test_kernels.py's
LSE_TOL = 2e-3                                    # f32 statistics either way
GUARD_TOL = 2e-2                                  # relative to max |logit|
GRAD_F32_TOL = 1e-3                               # f32 gradients, kernels vs plain
TILE_REL_TOL = 1e-2                               # backward, per 64-row tile
TC_PLAIN_TOL = 8e-3                               # a kernel vs its own bf16
                                                  # arithmetic: two bf16 ulps

# the JAX test cases of tests/test_kernels.py (B = 2), then rows of a d
# that is no multiple of 8 (element loads: the scalar tail) under the row
# mappings: a warp a row (3 and 4096 rows), 8 warps a row (8 rows: fewer
# than SMs), and the wide kernel past 2048 vectors of 16 bytes
RMSNORM_CASES = [(1, 7, 64), (4, 33, 128), (2, 256, 512)]
RMSNORM_RAGGED = [(3, 100), (4096, 1001), (8, 5003), (5, 20003)]
FLASH_CASES = [(128, 128, 4, 4, 64, True, 0), (128, 128, 8, 2, 64, True, 0),
               (256, 256, 4, 1, 32, True, 64), (64, 192, 4, 2, 64, False, 0),
               (96, 96, 2, 2, 128, True, 32), (96, 96, 4, 4, 80, True, 0)]
# the forward kernel's variants (B, S, T, Hq, Hkv, D, causal, window, kv_len):
# ragged prefill at S = T in {1, 2, 5, 37, 300, 511}; decode at S = 1 with
# GQA 1:1, 2:1 and 8:1 against T = 300 (no multiple of the 256-key chunk),
# kv_len at 1, 63, 64, 65, 255, 256, 257 and T; S = 2..4 causal; a window in
# both regimes; every head dim (tests/test_torch_cuda.py's cases)
DECODE_LENS = [1, 63, 64, 65, 255, 256, 257, 300]
FLASH_VARIANT_CASES = [
    (2, 1, 1, 4, 4, 64, True, 0, None), (2, 2, 2, 4, 2, 32, True, 0, None),
    (2, 5, 5, 4, 4, 80, True, 0, None), (2, 37, 37, 8, 2, 128, True, 0, None),
    (2, 300, 300, 4, 4, 64, True, 0, None), (2, 511, 511, 4, 1, 80, True, 0, None),
    (8, 1, 300, 4, 4, 64, False, 0, DECODE_LENS), (8, 1, 300, 8, 4, 32, False, 0, DECODE_LENS),
    (8, 1, 300, 32, 4, 128, False, 0, DECODE_LENS), (8, 1, 300, 4, 4, 80, False, 0, DECODE_LENS),
    (2, 2, 40, 4, 4, 64, True, 0, [40, 17]), (2, 3, 300, 8, 1, 128, True, 0, None),
    (2, 4, 100, 16, 2, 32, True, 0, [100, 3]), (2, 4, 300, 4, 4, 64, True, 2, [300, 150]),
    (2, 300, 300, 4, 2, 80, True, 64, None), (2, 200, 256, 4, 4, 32, False, 100, [256, 180]),
    (2, 37, 37, 4, 2, 96, True, 0, None), (2, 300, 300, 4, 2, 256, True, 128, None),
    (8, 1, 300, 8, 1, 96, False, 0, DECODE_LENS), (8, 1, 300, 4, 2, 256, False, 0, DECODE_LENS),
    (2, 4, 300, 4, 2, 256, True, 0, [300, 65])]
# the backward's: the JAX test cases, then every head dim with ragged S,
# windows and GQA up to 8:1 (gemma3's 2:1 at D = 256 with a window), each in
# f32 (the FMA kernels) and bf16 (the tensor-core kernels)
FLASH_BWD_CASES = [(128, 128, 4, 2, 32, True, 0), (128, 128, 4, 4, 64, True, 48),
                   (64, 192, 4, 1, 32, False, 0), (100, 100, 8, 2, 128, True, 40),
                   (77, 77, 8, 1, 32, True, 0), (300, 300, 16, 2, 64, True, 0),
                   (200, 200, 4, 4, 80, True, 0), (129, 129, 8, 1, 80, False, 0),
                   (150, 150, 8, 2, 96, True, 50), (70, 190, 4, 4, 96, False, 0),
                   (257, 257, 8, 1, 128, True, 0), (300, 300, 4, 2, 256, True, 128),
                   (65, 130, 8, 1, 256, False, 0), (3, 3, 4, 2, 128, True, 0),
                   (1, 40, 2, 1, 80, False, 0)]
# the grouped-GEMM cases of tests/test_kernels.py (E, C, D, F) and their
# (atol, rtol); then tokens per expert at qwen3-moe-30b-a3b's widths: one
# slot, a decode round of 8 slots, the least C of the tensor-core prefill
# kernel, a 511-token and a 256-token admission, a prefill step; then a D
# and F that meet the TMA rule (multiples of 8) but no tile's width
GMM_CASES = [(2, 64, 128, 96), (8, 128, 64, 256), (3, 96, 160, 32)]
GMM_TOL = {"float32": (1e-3, 1e-3), "bfloat16": (5e-1, 5e-2)}
GMM_RAGGED_C = (1, 8, 17, 40, 256, 320)
GMM_RAGGED_DF = (8, 100, 200, 72)
# bf16 (E, C, D, F, buf offset, w offset) where TMA cannot read, so the
# 64 x 64 wmma tile serves: buf's or w's base 2 bytes (one element) past a
# 16-byte boundary, at qwen3-moe's widths; D, then F no multiple of 8
GMM_WMMA_CASES = [(4, 320, 2048, 768, 1, 0), (4, 40, 768, 2048, 0, 1),
                  (4, 40, 2044, 768, 0, 0), (3, 100, 200, 76, 0, 0)]
# the SSD cases of tests/test_kernels.py (B, S, H, P, G, N), then ragged S
SSD_CASES = [(1, 64, 2, 32, 1, 16), (2, 128, 4, 32, 2, 16), (1, 96, 4, 64, 1, 32),
             (2, 256, 8, 64, 2, 64)]
SSD_RAGGED = [(2, S, 4, 64, 1, 128) for S in (1, 37, 257, 300)]
# the bf16 kernel's shapes (B, S, H, P, G, N): S at the edges of its 128-row
# chunk (1, Q - 1, Q, Q + 1, 2Q + 1), G = 2 and 4 with several heads a
# group (C·Bᵀ shared), every state dim, P = 32, 64, 128; each with the JAX
# tests' a range and with strong decay (a down to -16)
SSD_TC_CASES = [(2, 1, 4, 64, 1, 128), (1, 127, 8, 32, 2, 16), (1, 128, 8, 64, 2, 32),
                (2, 129, 16, 128, 4, 64), (1, 257, 8, 64, 4, 128), (2, 257, 16, 32, 4, 32),
                (1, 300, 8, 128, 2, 16), (2, 200, 8, 64, 2, 64)]
SSD_A_RANGES = ((0.5, 2.0), (1.0, 16.0))
# the config chunk the SSD's operation count is reckoned at, whatever the
# kernel's own tile
SSD_CHUNK = 256
# the grouped GEMM's backward (dX, dW): tokens per expert at qwen3-moe's
# widths (one slot, a decode round of 8, past the 16-row tile, a 511-token
# admission, a train microbatch), then (E, C, D, F, buf/dy offset, w
# offset) in bf16 where TMA cannot read, so the wmma tile serves: D, then F
# no multiple of 8, a base one element past a 16-byte boundary
GMM_BWD_C = (1, 8, 17, 40, 320)
GMM_BWD_WMMA_CASES = [(3, 100, 200, 76, 0, 0), (4, 40, 2044, 768, 0, 0),
                      (4, 17, 768, 2048, 1, 0), (4, 40, 2048, 768, 0, 1)]
# the SSD backward's (B, S, H, P, G, N): S ragged and at its 64-row tile's
# edges (1, 37, 127, 128, 129, 257, 300), G = 1, 2, 4 with several heads a
# group, every state dim, P = 32, 64, 128; each in f32 and bf16, strided
# xBC views, the JAX tests' a range and strong decay in turn, dh_final
# zero (None) and not in turn
SSD_BWD_CASES = [(2, 1, 4, 64, 1, 128), (1, 37, 8, 32, 2, 16), (2, 127, 4, 64, 1, 32),
                 (1, 128, 8, 128, 4, 64), (2, 129, 8, 32, 2, 128), (1, 257, 16, 64, 4, 16),
                 (1, 300, 8, 128, 2, 32), (2, 300, 4, 64, 1, 64)]
GUARD_PROMPT = 300                                # > one SSD chunk
TRAIN_STEPS = 4
SSM_CONFIGS = ("mamba2-370m", "zamba2-2.7b")
# trained after the serving phases, each at its profile_train.train_depth
TRAIN_CONFIGS = ("qwen3-moe-30b-a3b", "mamba2-370m", "zamba2-2.7b")
MOE_CONFIG = "qwen3-moe-30b-a3b"
GEMMA3_CONFIG = "gemma3-12b"
# the CWS-scheduled train launch: full-width qwen1.5-0.5b in one microbatch
# of 8 x 1024, a checkpoint task every 4 steps, profile_train's dense peak
# learning rate (the launch's own 3e-3 is untried at this width)
CWS_TRAIN = dict(arch="qwen1.5-0.5b", steps=8, chunk=2, batch=8, seq=1024,
                 ckpt_every=4, lr=1e-3)
CKPT_MIN_FREE_GB = 16.0       # two 4.6 GB checkpoints, a rewrite and room
RESUME_TOL = 5e-2             # max |Δloss| of the resumed steps
# the backward's timed shapes (B, S = T, Hq, Hkv, D, window), all causal:
# the train step's microbatch (qwen1.5-0.5b), qwen3-moe-30b-a3b's heads,
# zamba2-2.7b's shared block, a gemma3-12b local layer
BWD_PATHS = {"train": (4, 1024, 16, 16, 64, 0), "moe": (4, 1024, 32, 4, 128, 0),
             "zamba2": (4, 1024, 32, 32, 80, 0), "gemma3": (4, 1024, 16, 8, 256, 1024)}


def fail(msg: str) -> None:
    raise RuntimeError(f"chip_smoke: {msg}")


def compare(name, got, want, tol, rtol=None) -> float:
    """Fail unless |got - want| <= tol + rtol*|want| everywhere (rtol = tol
    unless given); → max abs err."""
    import torch
    torch.cuda.synchronize()
    rtol = tol if rtol is None else rtol
    g, w = got.float(), want.float()
    err = (g - w).abs()
    if g.shape != w.shape or not bool(torch.isfinite(g).all()) \
            or bool((err > tol + rtol * w.abs()).any()):
        fail(f"{name}: kernel disagrees with its plain version "
             f"(max abs err {float(err.max()):.3g}, tol {tol}, rtol {rtol})")
    return float(err.max())


def compare_tiles(name, got, want, tile=64) -> float:
    """Fail unless every tile of ``tile`` rows of each (batch, head) has
    ||got - want|| <= TILE_REL_TOL * ||want||; → the worst ratio. Scale-aware
    where the elementwise floor of ``compare`` is not: causal gradients shrink
    along the sequence, so a late tile gone wrong stands out here."""
    import torch.nn.functional as F
    B, S, H, D = want.shape
    pad = -S % tile        # zero rows add nothing to either norm
    g, w = (F.pad(t.float(), (0, 0, 0, 0, 0, pad)).reshape(B, -1, tile, H, D)
            for t in (got, want))
    ratio = float(((g - w).norm(dim=(2, 4)) / w.norm(dim=(2, 4)).clamp(min=1e-30)).max())
    if not ratio <= TILE_REL_TOL:
        fail(f"{name}: kernel disagrees with its plain version in a {tile}-row "
             f"tile (relative error {ratio:.3g}, tol {TILE_REL_TOL})")
    return ratio


def bound(bytes_moved: float, flops: float, flop_rate: float):
    t_bytes, t_ops = bytes_moved / PEAK_BYTES_PER_S, flops / flop_rate
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def device_phase():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this test needs a CUDA card")
    import repro_torch  # noqa: F401  (fails outside the repository)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(f"card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


def build_phase():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    lib = build.build()
    build.library()
    print(f"build: {time.perf_counter() - t0:.1f}s -> {lib.relative_to(ROOT)}")
    kernel = "?"
    for line in (lib.parent / "build.log").read_text().splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            kernel = _kernel_label(entry.group(1))
        elif "Used" in line and "registers" in line or "spill" in line:
            print(f"  ptxas {kernel}: {line.replace('ptxas info    :', '').strip()}")
        elif "warpgroup.arrive is injected" in line:   # names its function itself
            print(f"  ptxas {_kernel_label(line.split()[-1].strip(chr(39)))}: "
                  f"{line.split(' by compiler')[0].split(') ')[-1]} by the compiler")


def _kernel_label(mangled: str) -> str:
    """A mangled kernel name as ``name<template ints>`` (and its element
    type where the template has one), for the ptxas lines."""
    for run in re.finditer(r"\d+", mangled):
        for k in range(len(run.group())):
            n = int(run.group()[k:])
            name = mangled[run.end():run.end() + n]
            if len(name) == n and name.endswith("_kernel") and re.fullmatch(r"[a-z0-9_]+", name):
                head = mangled[run.end() + n:].split("EE")[0]
                args = [v if t == "i" else ("false", "true")[int(v)]
                        for t, v in re.findall(r"L([ib])(\d+)", head)]
                args += ["bf16"] if "bfloat16" in head else ["f32"] if head.startswith("If") else []
                return f"{name}<{', '.join(args)}>" if args else name
    return mangled


def rmsnorm_phase(gen):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.rmsnorm import rmsnorm_cuda, rmsnorm_plain
    from repro_torch.launch.kernel_times import device_ms, wrapper_ms
    worst = 0.0
    for shape in RMSNORM_CASES:
        for dt in (torch.float32, torch.bfloat16):
            x = torch.randn(shape, generator=gen, device="cuda").to(dt)
            s = (1 + 0.1 * torch.randn(shape[-1:], generator=gen, device="cuda")).to(dt)
            worst = max(worst, compare(f"rmsnorm {shape} {dt}", rmsnorm_cuda(x, s),
                                       rmsnorm_plain(x, s), TOL[str(dt)[6:]]))
    for rows, d in RMSNORM_RAGGED:
        for dt in (torch.float32, torch.bfloat16):
            x = torch.randn(rows, d, generator=gen, device="cuda").to(dt)
            s = (1 + 0.1 * torch.randn(d, generator=gen, device="cuda")).to(dt)
            worst = max(worst, compare(f"rmsnorm ragged ({rows}, {d}) {dt}",
                                       rmsnorm_cuda(x, s), rmsnorm_plain(x, s),
                                       TOL[str(dt)[6:]]))
    # (rows, d): qwen1.5-0.5b's prefill step and decode round, then
    # qwen3-moe-30b-a3b's (and mamba2-370m's gated norm), then zamba2-2.7b's
    # gated norm, then gemma3-12b's
    shape_by_path = {"prefill": (4 * 1024, 1024), "decode": (8, 1024),
                     "moe_prefill": (4 * 1024, 2048), "moe_decode": (8, 2048),
                     "zamba2_prefill": (4 * 1024, 5120), "zamba2_decode": (8, 5120),
                     "gemma3_prefill": (4 * 1024, 3840), "gemma3_decode": (8, 3840)}
    timed = {}
    for path, (rows, d) in shape_by_path.items():
        x = torch.randn(rows, d, generator=gen, device="cuda").to(torch.bfloat16)
        s = (1 + 0.1 * torch.randn(d, generator=gen, device="cuda")).to(torch.bfloat16)
        err = compare(f"rmsnorm {path} ({rows}, {d})", rmsnorm_cuda(x, s),
                      rmsnorm_plain(x, s), TOL["bfloat16"])
        worst = max(worst, err)
        b_ms, b_by = bound((2 * rows * d + d) * 2, 4.0 * rows * d, PEAK_F32_FLOPS)
        # the bound reads x from device memory, but up to 4096 x 5120 x and
        # its output fit in the 50 MB L2, where back-to-back calls find them:
        # ms, plain_ms and library_ms are taken with L2 flushed before each
        # call, the warm times beside them
        timed[path] = {
            "shape": f"x ({rows}, {d}) bf16", "max_abs_err": err,
            "ms": device_ms(lambda: rmsnorm_cuda(x, s), cold=True),
            "warm_ms": device_ms(lambda: rmsnorm_cuda(x, s)),
            "wrapper_ms": wrapper_ms(lambda: rmsnorm_cuda(x, s)),
            "plain_ms": device_ms(lambda: rmsnorm_plain(x, s), cold=True),
            "library_ms": device_ms(lambda: F.rms_norm(x, (d,), s, 1e-6), cold=True),
            "library_warm_ms": device_ms(lambda: F.rms_norm(x, (d,), s, 1e-6)),
            "bound_ms": b_ms, "bound_by": b_by}
        print(f"rmsnorm {path}: {json.dumps(timed[path])}")
    return worst, timed


def _flash_pair(q, k, v, causal, window, kv_len=None):
    from repro_torch.kernels.flash_attention import (
        flash_attention_cuda, flash_attention_plain)
    o, lse = flash_attention_cuda(q, k, v, causal=causal, window=window, kv_len=kv_len)
    po, plse = flash_attention_plain(q, k, v, causal=causal, window=window, kv_len=kv_len)
    return o, lse, po, plse


def _flash_check(name, q, k, v, causal, window, kv_len=None):
    """One forward call against the plain version: → (max abs err, variant)."""
    from repro_torch.kernels.flash_attention import _variant
    o, lse, po, plse = _flash_pair(q, k, v, causal, window, kv_len)
    err = max(compare(name + " O", o, po, TOL[str(q.dtype)[6:]]),
              compare(name + " lse", lse, plse, LSE_TOL))
    return err, _variant(q, k)


def flash_phase(gen):
    """The forward kernel against its plain version: the JAX test cases, the
    variants' cases (FLASH_VARIANT_CASES), q/k/v split from one fused
    projection, K/V as views of a stacked and of a fused cache, each in f32
    (the FMA kernel) and bf16 (tensor-core prefill or split-KV decode); the
    variant counts must match the shapes, FMA only for f32; a misaligned
    bf16 view must be refused. Then the six main-path shapes, timed."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    worst = 0.0
    ops.reset_launch_counts()
    want = {"tc_prefill": 0, "split_decode": 0, "fma": 0}

    def randn(*shape, dt):
        return torch.randn(shape, generator=gen, device="cuda").to(dt)

    for dt in (torch.float32, torch.bfloat16):
        cases = [(2, S, T, Hq, Hkv, D, c, w, None) for (S, T, Hq, Hkv, D, c, w) in FLASH_CASES]
        for (B, S, T, Hq, Hkv, D, causal, window, lens) in cases + FLASH_VARIANT_CASES:
            q, k, v = randn(B, S, Hq, D, dt=dt), randn(B, T, Hkv, D, dt=dt), \
                randn(B, T, Hkv, D, dt=dt)
            kv_len = None if lens is None else torch.tensor(lens, dtype=torch.int32,
                                                            device="cuda")
            err, variant = _flash_check(f"flash {(B, S, T, Hq, Hkv, D, causal, window)} {dt}",
                                        q, k, v, causal, window, kv_len)
            worst, want[variant] = max(worst, err), want[variant] + 1
        for (B, S, Hq, Hkv, D) in ((2, 300, 8, 2, 128), (2, 200, 32, 32, 80),
                                   (2, 150, 32, 32, 96), (2, 200, 16, 8, 256)):
            qkv = randn(B, S, (Hq + 2 * Hkv) * D, dt=dt)
            q, k, v = torch.split(qkv, [Hq * D, Hkv * D, Hkv * D], dim=-1)
            err, variant = _flash_check(f"flash fused qkv {(B, S, Hq, Hkv, D)} {dt}",
                                        q.view(B, S, Hq, D), k.view(B, S, Hkv, D),
                                        v.view(B, S, Hkv, D), True, 0)
            worst, want[variant] = max(worst, err), want[variant] + 1
        for (S, Hq, Hkv, D, causal) in ((1, 32, 4, 128, False), (1, 16, 16, 64, False),
                                        (4, 8, 2, 64, True), (1, 32, 32, 80, False),
                                        (1, 32, 32, 96, False), (1, 16, 8, 256, False),
                                        (3, 16, 8, 256, True)):
            L, B, slots = 3, 4, 700
            q = randn(B, S, Hq, D, dt=dt)
            kv_len = torch.tensor([1, 256, 513, slots], dtype=torch.int32, device="cuda")
            stacked, fused = randn(2, L, B, slots, Hkv, D, dt=dt), randn(B, slots, 2, Hkv, D, dt=dt)
            for kind, kc, vc in (("stacked", stacked[0, 1], stacked[1, 1]),
                                 ("fused", fused[:, :, 0], fused[:, :, 1])):
                err, variant = _flash_check(f"flash {kind} cache {(S, Hq, Hkv, D)} {dt}",
                                            q, kc, vc, causal, 0, kv_len)
                worst, want[variant] = max(worst, err), want[variant] + 1
    got = ops.flash_variant_counts()
    if got != want or want["fma"] != sum(want.values()) // 2:
        fail(f"flash variants launched {got}, expected {want} (FMA for f32 only)")
    shifted = torch.zeros(2 * 64 * 4 * 64 + 1, device="cuda", dtype=torch.bfloat16)[1:]
    try:
        flash_attention_cuda(shifted.view(2, 64, 4, 64), *(randn(2, 64, 4, 64,
                             dt=torch.bfloat16) for _ in range(2)), causal=True, window=0)
    except ValueError as e:
        print(f"flash: misaligned bf16 q refused ({e})")
    else:
        fail("flash: a misaligned bf16 view was not refused")
    print(f"flash: checked cases by variant {want}")

    timed = {
        # qwen1.5-0.5b: B=4, S=T=1024, 16 heads of 64, causal; decode B=8, S=1
        # against T=2048 cache slots, per-row kv_len 1..2048
        "prefill": _flash_path("prefill", gen, 4, 1024, 1024, 16, 16, 64,
                               "B=4 S=T=1024 H=16 D=64 causal bf16"),
        "decode": _flash_path("decode", gen, 8, 1, 2048, 16, 16, 64,
                              "B=8 S=1 T=2048 H=16 D=64 kv_len 1..2048 bf16"),
        # qwen3-moe-30b-a3b: the same with GQA 8:1, 32 query and 4 KV heads of 128
        "moe_prefill": _flash_path("moe_prefill", gen, 4, 1024, 1024, 32, 4, 128,
                                   "B=4 S=T=1024 Hq=32 Hkv=4 D=128 causal bf16"),
        "moe_decode": _flash_path("moe_decode", gen, 8, 1, 2048, 32, 4, 128,
                                  "B=8 S=1 T=2048 Hq=32 Hkv=4 D=128 kv_len 1..2048 bf16"),
        # zamba2-2.7b's shared block: 32 heads of 80
        "zamba2_prefill": _flash_path("zamba2_prefill", gen, 4, 1024, 1024, 32, 32, 80,
                                      "B=4 S=T=1024 H=32 D=80 causal bf16"),
        "zamba2_decode": _flash_path("zamba2_decode", gen, 8, 1, 2048, 32, 32, 80,
                                     "B=8 S=1 T=2048 H=32 D=80 kv_len 1..2048 bf16"),
        # gemma3-12b: 16 query and 8 KV heads of 256; a local layer's window
        # of 1024 (at S = 1024 every causal key lies inside it)
        "gemma3_prefill": _flash_path("gemma3_prefill", gen, 4, 1024, 1024, 16, 8, 256,
                                      "B=4 S=T=1024 Hq=16 Hkv=8 D=256 causal window 1024 bf16",
                                      window=1024),
        "gemma3_decode": _flash_path("gemma3_decode", gen, 8, 1, 2048, 16, 8, 256,
                                     "B=8 S=1 T=2048 Hq=16 Hkv=8 D=256 kv_len 1..2048 bf16"),
    }
    for t in timed.values():
        worst = max(worst, t["max_abs_err"])
    return worst, timed


def _causal_pairs(S, window):
    """Valid (query, key) pairs of one causal S x S head under ``window``."""
    return sum(min(q + 1, window) if window > 0 else q + 1 for q in range(S))


def _flash_path(path, gen, B, S, T, Hq, Hkv, D, shape, window=0):
    """The forward kernel at one main-path shape (bf16): checked against the
    plain version, device times of kernel, plain and SDPA, wrapper time and
    the bound. S = T is a causal prefill (a window of at least S changes
    nothing, so SDPA's causal call computes the same); S = 1 a decode step
    with per-row kv_len spread over 1..T."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (
        flash_attention_cuda, flash_attention_plain)
    from repro_torch.launch.kernel_times import device_ms, wrapper_ms
    bf16 = torch.bfloat16
    q = torch.randn(B, S, Hq, D, generator=gen, device="cuda").to(bf16)
    k, v = (torch.randn(B, T, Hkv, D, generator=gen, device="cuda").to(bf16)
            for _ in range(2))
    causal = S == T
    kv_len = None if causal else \
        torch.linspace(1, T, B, device="cuda").round().to(torch.int32)
    if window and not (causal and window >= S):
        fail(f"flash {path}: SDPA takes no window: want one of at least S")
    o, lse, po, plse = _flash_pair(q, k, v, causal, window, kv_len)
    err = max(compare(f"flash {path} O", o, po, TOL["bfloat16"]),
              compare(f"flash {path} lse", lse, plse, LSE_TOL))
    # bytes: q and O, the K/V each row may see, lse (and kv_len); operations:
    # 4·D per valid (query, key) pair
    if causal:
        pairs, kv_bytes = B * Hq * _causal_pairs(S, window), 2 * B * T * Hkv * D * 2
    else:
        valid = int(kv_len.sum())
        pairs, kv_bytes = Hq * valid, 2 * valid * Hkv * D * 2 + B * 4
    b_ms, b_by = bound(2 * B * S * Hq * D * 2 + kv_bytes + B * Hq * S * 4,
                       4.0 * D * pairs, PEAK_BF16_FLOPS)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    gqa = {"enable_gqa": True} if Hq != Hkv else {}
    if causal:
        def library():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, **gqa)
    else:
        mask = (torch.arange(T, device="cuda")[None, :] < kv_len[:, None])[:, None, None, :]

        def library():
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, **gqa)

    def kernel():
        return flash_attention_cuda(q, k, v, causal=causal, window=window, kv_len=kv_len)

    timed = {
        "shape": shape, "max_abs_err": err, "ms": device_ms(kernel),
        "wrapper_ms": wrapper_ms(kernel),
        "plain_ms": device_ms(lambda: flash_attention_plain(
            q, k, v, causal=causal, window=window, kv_len=kv_len), iters=5 if causal else 20),
        "library_ms": device_ms(library), "bound_ms": b_ms, "bound_by": b_by}
    print(f"flash_fwd {path}: {json.dumps(timed)}")
    return timed


def gmm_phase(gen):
    """The grouped expert GEMM against its plain version: the JAX test cases
    (f32 and bf16, tests/test_kernels.py's tolerances), ragged C at
    qwen3-moe-30b-a3b's widths and a D/F of no tile's width (f32 and bf16),
    the bf16 cases that TMA cannot read (GMM_WMMA_CASES: a misaligned base,
    D or F no multiple of 8), and the main-path shapes of one MoE layer
    (bf16, gate/up and down at C = 8, 40, 256, 320), which are also timed.
    Every launch's variant must be the one ``_variant`` names for its shape
    and bases: each bf16 launch with C > 16 on ``tc_prefill``, but those of
    GMM_WMMA_CASES, which must all be on ``wmma``."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.moe_gmm import _variant, moe_gmm_cuda, moe_gmm_plain
    from repro_torch.launch.kernel_times import (
        MOE_C, MOE_D, MOE_E, MOE_F, device_ms, wrapper_ms)

    def inputs(E, C, D, F, dt, w_std):
        buf = torch.randn(E, C, D, generator=gen, device="cuda").to(dt)
        return buf, (w_std * torch.randn(E, D, F, generator=gen, device="cuda")).to(dt)

    want = dict.fromkeys(ops.moe_gmm_variant_counts(), 0)

    def check(name, buf, w, atol, rtol=None, tma=True):
        E, C, D = buf.shape
        variant = _variant(buf.dtype, C, D, w.shape[2],
                           buf.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0)
        if buf.dtype == torch.bfloat16 and C > 16 and \
                variant != ("tc_prefill" if tma else "wmma"):
            fail(f"{name}: bf16 C = {C} would take {variant}")
        want[variant] += 1
        return compare(name, moe_gmm_cuda(buf, w), moe_gmm_plain(buf, w), atol, rtol)

    ops.reset_launch_counts()
    worst = 0.0
    for (E, C, D, F) in GMM_CASES:
        for dt in (torch.float32, torch.bfloat16):
            buf, w = inputs(E, C, D, F, dt, 0.5)
            atol, rtol = GMM_TOL[str(dt)[6:]]
            worst = max(worst, check(f"moe_gmm {(E, C, D, F)} {dt}", buf, w, atol, rtol))
    ragged = [(MOE_E, C, MOE_D, MOE_F) for C in GMM_RAGGED_C] + [GMM_RAGGED_DF]
    for (E, C, D, F) in ragged:
        for dt in (torch.float32, torch.bfloat16):
            buf, w = inputs(E, C, D, F, dt, D ** -0.5)
            worst = max(worst, check(f"moe_gmm ragged {(E, C, D, F)} {dt}", buf, w,
                                     TOL[str(dt)[6:]]))
    for (E, C, D, F, b_off, w_off) in GMM_WMMA_CASES:
        flat_buf = torch.randn(b_off + E * C * D, generator=gen, device="cuda")
        flat_w = D ** -0.5 * torch.randn(w_off + E * D * F, generator=gen, device="cuda")
        buf = flat_buf.to(torch.bfloat16)[b_off:].view(E, C, D)
        w = flat_w.to(torch.bfloat16)[w_off:].view(E, D, F)
        worst = max(worst, check(f"moe_gmm wmma {(E, C, D, F)} offsets {(b_off, w_off)}",
                                 buf, w, TOL["bfloat16"], tma=False))
    paths = {}
    for path, C in MOE_C.items():
        for part, (D, F) in (("gate_up", (MOE_D, MOE_F)), ("down", (MOE_F, MOE_D))):
            buf, w = inputs(MOE_E, C, D, F, torch.bfloat16, D ** -0.5)
            err = check(f"moe_gmm {path} {part}", buf, w, TOL["bfloat16"])
            worst = max(worst, err)
            paths[f"{path}_{part}"] = (buf, w, err)
    got = ops.moe_gmm_variant_counts()
    if got != want or got["wmma"] != len(GMM_WMMA_CASES):
        fail(f"moe_gmm launches by variant {got}, expected {want} with "
             f"{len(GMM_WMMA_CASES)} on wmma")
    print(f"moe_gmm variants: {got}")
    timed = {}
    for name, (buf, w, err) in paths.items():
        E, C, D = buf.shape
        F = w.shape[2]
        # each of buf, w and out once; 2 operations per multiply-add
        b_ms, b_by = bound((E * C * D + E * D * F + E * C * F) * 2, 2.0 * E * C * D * F,
                           PEAK_BF16_FLOPS)
        timed[name] = {
            "shape": f"buf ({E}, {C}, {D}) x w ({E}, {D}, {F}) bf16",
            "variant": _variant(buf.dtype, C, D, F, True),
            "max_abs_err": err, "ms": device_ms(lambda: moe_gmm_cuda(buf, w)),
            "wrapper_ms": wrapper_ms(lambda: moe_gmm_cuda(buf, w)),
            "plain_ms": device_ms(lambda: moe_gmm_plain(buf, w)),
            "library_ms": device_ms(lambda: torch.bmm(buf, w)),
            "bound_ms": b_ms, "bound_by": b_by}
        print(f"moe_gmm {name}: {json.dumps(timed[name])}")
    return worst, timed


def _ssd_inputs(gen, B, S, H, P, G, N, dt, a_range=(0.5, 2.0)):
    """xh, B_ and C_ as views into one (B, S, H·P + 2·G·N) tensor, as the
    model splits its xBC; dt ~ U[1e-3, 0.1] and a ~ -U[a_range] (the JAX
    tests' ranges; the model's init gives -U[1, 16])."""
    import torch
    xbc = torch.randn(B, S, H * P + 2 * G * N, generator=gen, device="cuda")
    xbc[..., H * P:] *= 0.5
    xs, b, c = torch.split(xbc.to(dt), [H * P, G * N, G * N], dim=-1)
    d = 1e-3 + 0.099 * torch.rand(B, S, H, generator=gen, device="cuda")
    lo, hi = a_range
    a = -(lo + (hi - lo) * torch.rand(H, generator=gen, device="cuda"))
    return (xs.reshape(B, S, H, P), d.to(dt), a.to(dt), b.reshape(B, S, G, N),
            c.reshape(B, S, G, N))


def ssd_phase(gen):
    """The SSD scan against its plain version, y and the final state: the
    JAX test cases and ragged S (f32 and bf16), the bf16 kernel's chunk
    edges, groups and widths (SSD_TC_CASES, both a ranges, f32 and bf16),
    the launches by variant checked; then the three main-path shapes (bf16,
    the model's a range), which are also timed."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.ssd_scan import ssd_scan_cuda, ssd_scan_plain
    from repro_torch.launch.kernel_times import SSD_PATHS, device_ms, wrapper_ms

    def check(name, ins, tol):
        """y at the inputs' tolerance; h_final at f32's whatever their type:
        both versions compute it in f32 from the same inputs."""
        y, h = ssd_scan_cuda(*ins)
        py, ph = ssd_scan_plain(*ins, chunk=SSD_CHUNK)
        return max(compare(f"{name} y", y, py, tol),
                   compare(f"{name} h_final", h, ph, TOL["float32"]))

    worst = 0.0
    ops.reset_launch_counts()
    checks = [(case, (0.5, 2.0)) for case in SSD_CASES + SSD_RAGGED] + \
        [(case, a_range) for case in SSD_TC_CASES for a_range in SSD_A_RANGES]
    for case, a_range in checks:
        for dt in (torch.float32, torch.bfloat16):
            ins = _ssd_inputs(gen, *case, dt, a_range=a_range)
            worst = max(worst, check(f"ssd_scan {case} a {a_range} {dt}", ins,
                                     TOL[str(dt)[6:]]))
    want = {"tc": len(checks), "fma": len(checks)}
    if ops.ssd_scan_variant_counts() != want:
        fail(f"ssd_scan variants {ops.ssd_scan_variant_counts()}, expected {want} "
             f"(the tensor-core kernel for bf16, FMA for f32)")
    print(f"ssd_scan: checked cases by variant {want}")
    timed = {}
    for path, (B, S, H, P, G, N) in SSD_PATHS.items():
        ins = _ssd_inputs(gen, B, S, H, P, G, N, torch.bfloat16, a_range=(1.0, 16.0))
        err = check(f"ssd_scan {path}", ins, TOL["bfloat16"])
        worst = max(worst, err)
        # bytes: x, dt, B, C read once, y and the f32 final state written once;
        # operations of the chunked form at the config's chunk Q, counting
        # only the causal half (j <= i: (Q+1)/2 per row) of the Q x Q
        # products C·Bᵀ and M·x, and the state's two products in full
        nbytes = (2 * B * S * H * P + B * S * H + 2 * B * S * G * N) * 2 + B * H * P * N * 4
        flops = float(B * H * S) * ((SSD_CHUNK + 1) * (N + P) + 4 * P * N)
        b_ms, b_by = bound(nbytes, flops, PEAK_BF16_FLOPS)
        timed[path] = {
            "shape": f"B={B} S={S} H={H} P={P} G={G} N={N} bf16, strided xh/B/C",
            "max_abs_err": err, "ms": device_ms(lambda: ssd_scan_cuda(*ins)),
            "wrapper_ms": wrapper_ms(lambda: ssd_scan_cuda(*ins)),
            "plain_ms": device_ms(lambda: ssd_scan_plain(*ins, chunk=SSD_CHUNK), iters=5),
            "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}
        print(f"ssd_scan {path}: {json.dumps(timed[path])}")
    return worst, timed


def gmm_bwd_phase(gen):
    """The grouped GEMM's dX and dW kernels against ``moe_gmm_bwd_plain``,
    f32 and bf16: GMM_BWD_C at qwen3-moe's widths (gate/up), D/F of no
    tile's width and a misaligned base (GMM_BWD_WMMA_CASES, bf16), then the
    train microbatch's gate/up and down at C = 320, also held per 64-row
    tile and timed (beside ``torch.bmm`` of the same product). Tolerance:
    TOL relative and TOL of the largest |value| (the products sum F or C
    terms in another order). Every launch on the variant ``_bwd_variant``
    names: bf16 on ``tc`` but GMM_BWD_WMMA_CASES, on ``wmma``."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.moe_gmm import (
        _bwd_variant, moe_gmm_bwd_plain, moe_gmm_dw_cuda, moe_gmm_dx_cuda)
    from repro_torch.launch.kernel_times import (
        MOE_D, MOE_E, MOE_F, MOE_TRAIN_C, device_ms, wrapper_ms)
    worst = {"moe_gmm_dx": 0.0, "moe_gmm_dw": 0.0}
    want = {name: {"tc": 0, "wmma": 0, "fma": 0} for name in worst}

    def check(name, buf, w, dy, tma=True, tiles=None):
        """dX reads dy and w, dW buf and dy: each product's variant goes by
        its own operands' bases (a misaligned w leaves dW on ``tc``)."""
        dt = str(buf.dtype)[6:]
        for kern, operands in (("moe_gmm_dx", (dy, w)), ("moe_gmm_dw", (buf, dy))):
            variant = _bwd_variant(buf.dtype, buf.shape[2], w.shape[2],
                                   all(t.data_ptr() % 16 == 0 for t in operands))
            if buf.dtype == torch.bfloat16 and tma and variant != "tc":
                fail(f"{name}: bf16 {kern} would take {variant}")
            want[kern][variant] += 1
        got = (moe_gmm_dx_cuda(dy, w), moe_gmm_dw_cuda(buf, dy))
        for kern, g, p in zip(worst, got, moe_gmm_bwd_plain(buf, w, dy)):
            tol = TOL[dt] * float(p.float().abs().max())
            worst[kern] = max(worst[kern], compare(f"{name} {kern}", g, p, tol, TOL[dt]))
            if tiles is not None:
                tiles[kern] = compare_tiles(f"{name} {kern}", g[None], p[None])

    def randn(*shape, std=1.0):
        return std * torch.randn(shape, generator=gen, device="cuda")

    ops.reset_launch_counts()
    for C in GMM_BWD_C:
        for dt in (torch.float32, torch.bfloat16):
            check(f"moe_gmm bwd C={C} {dt}", randn(MOE_E, C, MOE_D).to(dt),
                  randn(MOE_E, MOE_D, MOE_F, std=MOE_D ** -0.5).to(dt),
                  randn(MOE_E, C, MOE_F).to(dt))
    for (E, C, D, F, x_off, w_off) in GMM_BWD_WMMA_CASES:
        buf = randn(x_off + E * C * D).bfloat16()[x_off:].view(E, C, D)
        dy = randn(x_off + E * C * F).bfloat16()[x_off:].view(E, C, F)
        w = randn(w_off + E * D * F, std=D ** -0.5).bfloat16()[w_off:].view(E, D, F)
        check(f"moe_gmm bwd wmma {(E, C, D, F)} offsets {(x_off, w_off)}", buf, w, dy,
              tma=False)
    inputs, tile_rel = {}, {}
    for part, (D, F) in (("train_gate_up", (MOE_D, MOE_F)), ("train_down", (MOE_F, MOE_D))):
        E, C = MOE_E, MOE_TRAIN_C
        inputs[part] = (randn(E, C, D).bfloat16(), randn(E, D, F, std=D ** -0.5).bfloat16(),
                        randn(E, C, F).bfloat16())
        tile_rel[part] = {}
        check(f"moe_gmm bwd {part}", *inputs[part], tiles=tile_rel[part])
    got = ops.moe_gmm_bwd_variant_counts()
    # every GMM_BWD_WMMA_CASES case puts dX on wmma; dW all but the one
    # whose only misaligned operand is w
    if got != want or (want["moe_gmm_dx"]["wmma"], want["moe_gmm_dw"]["wmma"]) != \
            (len(GMM_BWD_WMMA_CASES), len(GMM_BWD_WMMA_CASES) - 1):
        fail(f"moe_gmm backward launches by variant {got}, expected {want}")
    print(f"moe_gmm backward: checked cases by variant {want}")
    timed = {"moe_gmm_dx": {}, "moe_gmm_dw": {}}
    for part, (buf, w, dy) in inputs.items():
        E, C, D = buf.shape
        F = w.shape[2]
        plain_ms = device_ms(lambda: moe_gmm_bwd_plain(buf, w, dy))
        calls = {  # (call, torch.bmm of the same product, output shape)
            "moe_gmm_dx": (lambda: moe_gmm_dx_cuda(dy, w),
                           lambda: torch.bmm(dy, w.transpose(1, 2)), f"dy ({E}, {C}, {F}) · "
                           f"w ({E}, {D}, {F})ᵀ -> ({E}, {C}, {D}) bf16"),
            "moe_gmm_dw": (lambda: moe_gmm_dw_cuda(buf, dy),
                           lambda: torch.bmm(buf.transpose(1, 2), dy), f"buf ({E}, {C}, "
                           f"{D})ᵀ · dy ({E}, {C}, {F}) -> ({E}, {D}, {F}) bf16")}
        for name, (call, library, shape) in calls.items():
            # each of the two inputs and the output once; 2 operations per
            # multiply-add of the E·C·D·F product
            b_ms, b_by = bound((E * C * D + E * D * F + E * C * F) * 2, 2.0 * E * C * D * F,
                               PEAK_BF16_FLOPS)
            timed[name][part] = {
                "shape": shape, "variant": "tc", "max_abs_err": worst[name],
                "max_tile_rel_err": tile_rel[part][name], "ms": device_ms(call),
                "wrapper_ms": wrapper_ms(call), "plain_ms": plain_ms,
                "plain_covers": "dX and dW together", "library_ms": device_ms(library),
                "library": "torch.bmm", "bound_ms": b_ms, "bound_by": b_by}
            print(f"{name} {part}: {json.dumps(timed[name][part])}")
    return worst, timed


def ssd_bwd_phase(gen):
    """The SSD backward against ``ssd_scan_bwd_plain``: SSD_BWD_CASES in f32
    (``fma``) and bf16 (``tc``), strided views, both a ranges, dh_final
    zero and not, every output held to TOL relative and TOL of its largest
    |value| (dB, dC, ddt and da are f32 sums across blocks, over a group's
    heads, the P tiles, batch and sequence: in no fixed order) and dxh, dB,
    dC per 64-row tile of each (batch, head or group) within TILE_REL_TOL;
    ``tc`` also within TC_PLAIN_TOL of ``ssd_scan_bwd_tc_plain`` (its own
    arithmetic: the same bf16 roundings, another summation order);
    launches by variant checked. Then the train microbatches of mamba2-370m
    and zamba2-2.7b (bf16, strong decay, dh_final None as in training),
    also timed: ``tc`` whole and by its three kernels, and ``fma`` on the
    same values in f32."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.ssd_scan import (
        ssd_scan_bwd_cuda, ssd_scan_bwd_plain, ssd_scan_bwd_tc_plain)
    from repro_torch.launch.kernel_times import (
        SSD_BWD_TC_STAGES, SSD_TRAIN_PATHS, device_ms, wrapper_ms)
    names = ("dxh", "ddt", "da", "dB", "dC")

    def held(name, got, want, tol, tiles):
        err, tile = 0.0, 0.0
        for part, g, w in zip(names, got, want):
            # at least 1e-3: at S = 1 da is exactly 0 and the kernel's
            # cancelling f32 sums leave ~1e-9
            scale = max(float(w.float().abs().max()), 1e-3)
            err = max(err, compare(f"{name} {part}", g, w, tol * scale, tol) / scale)
            if tiles and part in ("dxh", "dB", "dC"):
                tile = max(tile, compare_tiles(f"{name} {part}", g, w))
        return err, tile

    def check(name, ins, dy, dh, tol):
        """→ (worst error of the largest value against the plain version,
        worst 64-row tile, worst against the kernel's own arithmetic)."""
        got = ssd_scan_bwd_cuda(*ins, dy, dh)
        err, tile = held(name, got, ssd_scan_bwd_plain(*ins, dy, dh), tol, True)
        own = 0.0
        if dy.dtype == torch.bfloat16:
            own, _ = held(f"{name} (tc arithmetic)", got,
                          ssd_scan_bwd_tc_plain(*ins, dy, dh), TC_PLAIN_TOL, False)
        return err, tile, own

    worst, worst_tile, worst_own = 0.0, 0.0, 0.0
    ops.reset_launch_counts()
    for i, case in enumerate(SSD_BWD_CASES):
        B, S, H, P, G, N = case
        for dt in (torch.float32, torch.bfloat16):
            ins = _ssd_inputs(gen, *case, dt, a_range=SSD_A_RANGES[i % 2])
            dy = torch.randn(B, S, H, P, generator=gen, device="cuda").to(dt)
            dh = None if i % 3 == 0 else torch.randn(B, H, P, N, generator=gen, device="cuda")
            err, tile, own = check(f"ssd_scan_bwd {case} {dt} dh_final "
                                   f"{'zero' if dh is None else 'random'}", ins, dy, dh,
                                   TOL[str(dt)[6:]])
            worst, worst_tile, worst_own = max(worst, err), max(worst_tile, tile), \
                max(worst_own, own)
    n = len(SSD_BWD_CASES)
    if ops.ssd_scan_bwd_variant_counts() != {"tc": n, "fma": n}:
        fail(f"ssd_scan_bwd launches by variant {ops.ssd_scan_bwd_variant_counts()}, "
             f"expected {n} each (bf16 on tc, f32 on fma)")
    print(f"ssd_scan_bwd: {2 * n} cases within tolerance; worst error {worst:.3g} of the "
          f"largest value, worst 64-row tile {worst_tile:.3g} relative, tc against its own "
          f"arithmetic {worst_own:.3g}")
    timed = {"tc": {}, "fma": {}}
    for path, (B, S, H, P, G, N) in SSD_TRAIN_PATHS.items():
        ins = _ssd_inputs(gen, B, S, H, P, G, N, torch.bfloat16, a_range=(1.0, 16.0))
        dy = torch.randn(B, S, H, P, generator=gen, device="cuda").bfloat16()
        err, tile, own = check(f"ssd_scan_bwd {path}", ins, dy, None, TOL["bfloat16"])
        worst, worst_tile, worst_own = max(worst, err), max(worst_tile, tile), max(worst_own, own)
        # bytes: x, dy, dt, B, C read once; dx, ddt, dB, dC, da written once
        # in the inputs' type; operations of the chunked backward at the bf16
        # forward's chunk Q = 128, the Q x Q products counted over their
        # causal half: C·Bᵀ, dy·xᵀ, Mᵀ·dy, W·B, Wᵀ·C ((Q+1)·(3N+2P) a row),
        # and five (Q x P)·(P x N)-sized products a row (B·gᵀ, dy·h_in,
        # x·g, the g update, the recomputed state: 10·P·N); at the bf16
        # tensor-core rate for bf16 inputs, the f32 one for f32
        rows = B * S * H
        flops = float(rows) * ((128 + 1) * (3 * N + 2 * P) + 10 * P * N)
        elems = 2 * (2 * rows * P + B * S * H + 2 * B * S * G * N) + H
        f32_ins = tuple(t.float() for t in ins)
        for variant, xs, dys, size, rate in (
                ("tc", ins, dy, 2, PEAK_BF16_FLOPS),
                ("fma", f32_ins, dy.float(), 4, PEAK_F32_FLOPS)):
            b_ms, b_by = bound(elems * size, flops, rate)
            call = lambda xs=xs, dys=dys: ssd_scan_bwd_cuda(*xs, dys)   # noqa: E731
            timed[variant][path] = {
                "shape": f"B={B} S={S} H={H} P={P} G={G} N={N} "
                         f"{'bf16' if variant == 'tc' else 'f32'}, strided xh/B/C, "
                         f"dh_final none",
                "ms": device_ms(call, kernel="ssd_scan_bwd"),
                "ms_with_casts_and_zeroing": device_ms(call), "wrapper_ms": wrapper_ms(call),
                "plain_ms": device_ms(lambda xs=xs, dys=dys: ssd_scan_bwd_plain(*xs, dys),
                                      iters=3),
                "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}
            if variant == "tc":
                timed[variant][path].update(
                    max_rel_err=err, max_tile_rel_err=tile, max_rel_err_own_arithmetic=own,
                    ms_by_kernel={stage: device_ms(call, kernel=k)
                                  for stage, k in SSD_BWD_TC_STAGES.items()})
            print(f"ssd_scan_bwd {variant} {path}: {json.dumps(timed[variant][path])}")
    # the checks above ran on both variants; the path's launches are counted
    # in the train phase
    return worst, timed


def expected_launches(cfg):
    """Launches per prefill and per decode round of the serving path: → two
    dicts over the kernels on the path."""
    L = cfg.n_layers
    if cfg.family == "ssm":         # per layer: the SSD, the pre-norm, the gated norm
        norms = 2 * L + 1
        return {"ssd_scan": L, "rmsnorm": norms}, {"ssd_scan": 0, "rmsnorm": norms}
    if cfg.family == "hybrid":      # and per shared-block application 2 norms, 1 attention
        g = L // cfg.hybrid.attn_every
        norms = 2 * L + 2 * g + 1
        return ({"ssd_scan": L, "rmsnorm": norms, "flash_fwd": g},
                {"ssd_scan": 0, "rmsnorm": norms, "flash_fwd": g})
    # attention once per layer, two norms per layer and the final one, three
    # expert GEMMs per MoE layer
    each = {"flash_fwd": L, "rmsnorm": 2 * L + 1}
    if cfg.family == "moe":
        each["moe_gmm"] = 3 * L
    return each, dict(each)


def first_logits_alone(model, params, prompt):
    """First-token logits of ``prompt`` served alone (one slot: one prefill
    of ``prompt[:-1]``, one decode step)."""
    from repro_torch.runtime.serve import ContinuousBatcher, Request
    solo = ContinuousBatcher(model, params, batch_slots=1, max_len=2048)
    alone = Request("alone", list(prompt), max_new_tokens=1)
    solo.submit(alone)
    solo.drain()
    return alone.first_logits


def guard(name, a, b):
    rel = float((a - b).abs().max() / b.abs().max())
    print(f"{name}: rel err {rel:.3g}")
    if not rel <= GUARD_TOL:
        fail(f"{name}: first-token logits differ by {rel:.3g} of the largest")
    return rel


def _prefilled_and_fed(model, params, prompt):
    """First-token logits of ``prompt`` admitted by one prefill (the
    kernel's final state, cast once to the cache's dtype), and after feeding
    it token by token through ``decode_step`` from an empty cache (the
    recurrent form, the state rounded to the cache's dtype at every step),
    as repro's batcher admits it."""
    import torch
    prefilled = first_logits_alone(model, params, prompt).float()
    cache = model.init_cache(1, 2048)
    for t, tok in enumerate(prompt):
        logits, cache = model.decode_step(
            params, cache, torch.tensor([tok], device="cuda"), t)
    return prefilled, logits[0].float()


def state_guard(model, params):
    """The two admissions of one prompt against each other. In f32 (the same
    weights cast up) they differ only by how the state was reached, so they
    must agree within GUARD_TOL. In bf16 each sits some 6 % of the largest
    logit from the f32 result (full-width models, seed 0; as far at 64
    tokens as at 300, so bf16 rounding through the layers, not the state):
    there the prefill must be no farther from the f32 result than the
    token-by-token feed is, plus GUARD_TOL."""
    import torch
    from repro_torch.models import build_model

    def cast(t):
        return {k: cast(v) for k, v in t.items()} if isinstance(t, dict) else t.float()

    rng = torch.Generator("cuda").manual_seed(2)
    prompt = torch.randint(2, model.cfg.vocab, (GUARD_PROMPT,), device="cuda",
                           generator=rng).tolist()
    m32 = build_model(model.cfg.scaled(param_dtype="float32"), "cuda")
    pre32, fed32 = _prefilled_and_fed(m32, cast(params), prompt)
    guard(f"state guard f32 (prompt {GUARD_PROMPT}): prefill vs token by token",
          pre32, fed32)
    pre, fed = _prefilled_and_fed(model, params, prompt)
    rel = {name: float((x - fed32).abs().max() / fed32.abs().max())
           for name, x in (("prefill", pre), ("token_by_token", fed))}
    print(f"state guard bf16 (prompt {GUARD_PROMPT}): rel err against f32 {rel}, "
          f"prefill vs token by token {float((pre - fed).abs().max() / fed.abs().max()):.3g}")
    if not rel["prefill"] <= rel["token_by_token"] + GUARD_TOL:
        fail(f"state guard bf16: the prefill is {rel['prefill']:.3g} from the f32 "
             f"result, the token-by-token feed {rel['token_by_token']:.3g}")


def serve_phase(config="qwen1.5-0.5b"):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import ops
    from repro_torch.launch import serve_workload
    from repro_torch.models import build_model
    from repro_torch.models.layers import tree_leaves
    from repro_torch.runtime.serve import make_prefill_step

    cfg = get_config(config)
    model = build_model(cfg, "cuda")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    print(f"model: {cfg.name} full width, {cfg.n_layers} layers, "
          f"{model.n_params() / 1e6:.1f}M params, {cfg.param_dtype}; init "
          f"{time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 1e9:.3f} GB allocated")
    B, S = 4, 1024
    step = make_prefill_step(model, ShapeConfig("prefill_1k", S, B, "prefill"))
    tokens = torch.randint(2, cfg.vocab, (B, S), device="cuda",
                           generator=torch.Generator("cuda").manual_seed(1))

    # ---- the main path: counts from 0, read right after ----
    ops.reset_launch_counts()
    step({"params": params, "tokens": tokens})                 # warm-up
    torch.cuda.synchronize()
    per_prefill = ops.launch_counts()
    t0 = time.perf_counter()
    nxt, cache = step({"params": params, "tokens": tokens})
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    served = serve_workload.run(model, params, smoke=False, seed=0)
    launches = ops.launch_counts()
    variants = ops.flash_variant_counts()
    gmm_variants = ops.moe_gmm_variant_counts()
    ssd_variants = ops.ssd_scan_variant_counts()
    # ---- end of the main path ----

    if nxt.shape != (B,) or not all(bool(torch.isfinite(c).all())
                                    for c in tree_leaves(cache)):
        fail("prefill step: wrong shape or non-finite cache")
    reqs, batcher = served["requests"], served["batcher"]
    if served["served"] != len(reqs) or not all(r.tokens_out for r in reqs):
        fail(f"served {served['served']}/{len(reqs)} requests")
    if not batcher.all_logits_finite():
        fail("a decode round produced non-finite logits")
    # launches of one decode round, from the main path's own counts: two
    # prefill steps, one prefill per admission, then the engine's rounds
    prefills, rounds = 2 + batcher.prefills, batcher.steps
    want_prefill, want_round = expected_launches(cfg)
    for name in [k for k in launches if k not in want_prefill]:   # not on this path
        if launches.pop(name) + per_prefill.pop(name):
            fail(f"kernel {name} launched while serving {cfg.name}")
    # a kernel of the path must run in it; one that runs only in prefills
    # (the SSD scan) leaves 0 launches to the decode rounds
    per_round = {}
    for name, n in launches.items():
        decode_launches = n - per_prefill[name] * prefills
        if n <= 0 or rounds <= 0 or decode_launches < 0 or decode_launches % rounds:
            fail(f"kernel {name}: {n} launches do not split into {prefills} prefills "
                 f"of {per_prefill[name]} and {rounds} equal decode rounds")
        per_round[name] = decode_launches // rounds
    if per_prefill != want_prefill or per_round != want_round:
        fail(f"{cfg.name}: launches per prefill {per_prefill} and per decode round "
             f"{per_round}, expected {want_prefill} and {want_round}")
    # bf16 attention: every prefill (prompts of 32 tokens and more) on the
    # tensor-core kernel, every decode round on the split-KV one, never FMA
    if "flash_fwd" in per_prefill:
        want_variants = {"tc_prefill": per_prefill["flash_fwd"] * prefills,
                         "split_decode": per_round["flash_fwd"] * rounds, "fma": 0}
        if variants != want_variants:
            fail(f"{cfg.name}: flash variants {variants}, expected {want_variants}")
        print(f"flash variants: {variants}")
    elif any(variants.values()):
        fail(f"{cfg.name}: flash variants {variants} launched without attention")
    # the grouped GEMM: every prefill's launch (C > 16 tokens per expert) on
    # the tensor-core kernel, every decode round's (C = 8) on the decode one
    if "moe_gmm" in per_prefill:
        want_gmm = {"tc_prefill": per_prefill["moe_gmm"] * prefills,
                    "decode": per_round["moe_gmm"] * rounds, "wmma": 0, "fma": 0}
        if gmm_variants != want_gmm:
            fail(f"{cfg.name}: moe_gmm variants {gmm_variants}, expected {want_gmm}")
        print(f"moe_gmm variants: {gmm_variants}")
    # the SSD scan: every launch (prefills only) on the tensor-core kernel
    if "ssd_scan" in per_prefill:
        want_ssd = {"tc": per_prefill["ssd_scan"] * prefills, "fma": 0}
        if ssd_variants != want_ssd:
            fail(f"{cfg.name}: ssd_scan variants {ssd_variants}, expected {want_ssd}")
        print(f"ssd_scan variants: {ssd_variants}")
    elif any(ssd_variants.values()):
        fail(f"{cfg.name}: ssd_scan variants {ssd_variants} launched without an SSM")
    tok_s = served["tokens"] / served["seconds"]
    print(f"prefill step B={B} S={S}: {prefill_ms:.3f} ms")
    print(f"served {served['served']} requests, {served['tokens']} tokens in "
          f"{served['seconds']:.3f} s: {tok_s:.1f} generated tokens/s "
          f"({served['engine_steps']} engine rounds, prefills included)")
    print(f"peak memory {torch.cuda.max_memory_allocated() / 1e9:.3f} GB")

    # guard against cross-slot writes (K/V or state): first-token logits
    # alone vs batched
    for r in (served["order"][1], served["order"][-1]):   # first and last wave
        guard(f"cross-slot guard {r.req_id} (prompt {len(r.prompt)})", r.first_logits,
              first_logits_alone(model, params, r.prompt))
    if cfg.family in ("ssm", "hybrid"):
        state_guard(model, params)

    print(f"launches: main path {launches} over {prefills} prefills and {rounds} "
          f"decode rounds; per prefill {per_prefill}, per decode round {per_round}")
    launches["flash_fwd_variants"] = variants
    launches["moe_gmm_variants"] = gmm_variants
    launches["ssd_scan_variants"] = ssd_variants
    return launches, per_prefill, per_round


def flash_bwd_phase(gen):
    """The backward kernels against the plain version: FLASH_BWD_CASES in f32
    (the FMA kernels) and bf16 (the tensor-core kernels), the launches by
    variant checked; then the four BWD_PATHS shapes (bf16, O and lse from
    the forward kernel), each also held per 64-row tile and timed."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import (
        _delta, flash_attention_bwd_cuda, flash_attention_bwd_plain,
        flash_attention_cuda, flash_bwd_dkv_cuda, flash_bwd_dq_cuda)
    from repro_torch.launch.kernel_times import device_ms, wrapper_ms
    worst = {"flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0}   # each kernel's own outputs
    tile_rel = {}

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    def check(name, q, k, v, do, causal, window, tol, tiles=None):
        o, lse = flash_attention_cuda(q, k, v, causal=causal, window=window)
        got = flash_attention_bwd_cuda(q, k, v, o, lse, do, causal=causal, window=window)
        want = flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                         window=window)
        for part, g, w in zip(("dq", "dk", "dv"), got, want):
            kern = "flash_bwd_dq" if part == "dq" else "flash_bwd_dkv"
            worst[kern] = max(worst[kern], compare(f"{name} {part}", g, w, tol))
            if tiles is not None:
                tiles[kern] = max(tiles.get(kern, 0.0), compare_tiles(f"{name} {part}", g, w))
        return o, lse

    ops.reset_launch_counts()
    for (S, T, Hq, Hkv, D, causal, window) in FLASH_BWD_CASES:
        for dt in (torch.float32, torch.bfloat16):
            q, do = randn(2, S, Hq, D).to(dt), randn(2, S, Hq, D).to(dt)
            k, v = randn(2, T, Hkv, D).to(dt), randn(2, T, Hkv, D).to(dt)
            check(f"flash bwd {(S, T, Hq, Hkv, D, causal, window)} {dt}",
                  q, k, v, do, causal, window, TOL[str(dt)[6:]])
    n = len(FLASH_BWD_CASES)
    want = {name: {"tc": n, "fma": n} for name in worst}
    if ops.flash_bwd_variant_counts() != want:
        fail(f"flash bwd variants {ops.flash_bwd_variant_counts()}, expected {want} "
             f"(the tensor-core kernels for bf16, FMA for f32)")
    print(f"flash bwd: checked cases by variant {want}")

    timed = {name: {} for name in worst}
    for path, (B, S, Hq, Hkv, D, window) in BWD_PATHS.items():
        q, do = (randn(B, S, Hq, D).to(torch.bfloat16) for _ in range(2))
        k, v = (randn(B, S, Hkv, D).to(torch.bfloat16) for _ in range(2))
        tile_rel[path] = {}
        o, lse = check(f"flash bwd {path}", q, k, v, do, True, window, TOL["bfloat16"],
                       tiles=tile_rel[path])
        delta = _delta(o, do).contiguous()
        pairs = B * Hq * _causal_pairs(S, window)
        q_b, kv_b, stat_b = B * S * Hq * D * 2, B * S * Hkv * D * 2, B * Hq * S * 4
        plain_ms = device_ms(lambda: flash_attention_bwd_plain(
            q, k, v, o, lse, do, causal=True, window=window), iters=5)
        # SDPA has no window; gemma3's 1024 at S = 1024 leaves every causal key
        if window and window < S:
            fail(f"flash bwd {path}: SDPA takes no window: want one of at least S")
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                             **({"enable_gqa": True} if Hq != Hkv else {}))
        dot = do.transpose(1, 2)
        library_ms = device_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                                           retain_graph=True))
        shape = (f"B={B} S=T={S} Hq={Hq} Hkv={Hkv} D={D} causal"
                 f"{f' window {window}' if window else ''} bf16")
        calls = {
            # (call, bytes: inputs once + outputs once, operations per valid pair)
            "flash_bwd_dq": (lambda: flash_bwd_dq_cuda(q, k, v, do, lse, delta, causal=True,
                                                       window=window),
                             3 * q_b + 2 * kv_b + 2 * stat_b, 3 * 2 * D),
            "flash_bwd_dkv": (lambda: flash_bwd_dkv_cuda(q, k, v, do, lse, delta,
                                                         causal=True, window=window),
                              2 * q_b + 4 * kv_b + 2 * stat_b, 4 * 2 * D),
        }
        for name, (call, nbytes, per_pair) in calls.items():
            b_ms, b_by = bound(nbytes, float(per_pair) * pairs, PEAK_BF16_FLOPS)
            timed[name][path] = {
                "shape": shape, "ms": device_ms(call, kernel=f"{name}_tc_kernel"),
                "max_tile_rel_err": tile_rel[path][name],
                "wrapper_ms": wrapper_ms(call), "plain_ms": plain_ms,
                "library_ms": library_ms, "bound_ms": b_ms, "bound_by": b_by,
                "plain_and_library_cover": "dq, dk and dv together"}
            print(f"{name} {path}: {json.dumps(timed[name][path])}")
        whole_ms = wrapper_ms(lambda: flash_attention_bwd_cuda(q, k, v, o, lse, do,
                                                               window=window))
        print(f"flash_attention_bwd_cuda (dq + dkv + delta) {path}: wrapper {whole_ms:.4f} ms")
    return worst, timed


def expected_train_launches(cfg, n_micro):
    """Launches per train step under remat "block": per microbatch every
    layer's forward kernels run twice (once recomputed) and its backward
    kernels once; the final norm once (RMSNorm's backward is plain)."""
    L = cfg.n_layers
    if cfg.family in ("ssm", "hybrid"):   # per Mamba layer: the SSD, 2 norms
        g = L // cfg.hybrid.attn_every if cfg.family == "hybrid" else 0
        each = {"ssd_scan": 2 * L, "ssd_scan_bwd": L, "rmsnorm": 2 * (2 * L + 2 * g) + 1}
        if g:                             # the shared block: 1 attention, 2 norms
            each.update(flash_fwd=2 * g, flash_bwd_dq=g, flash_bwd_dkv=g)
    else:                                 # attention and 2 norms a layer
        each = {"flash_fwd": 2 * L, "flash_bwd_dq": L, "flash_bwd_dkv": L,
                "rmsnorm": 4 * L + 1}
        if cfg.family == "moe":           # and three expert GEMMs
            each.update(moe_gmm=6 * L, moe_gmm_dx=3 * L, moe_gmm_dw=3 * L)
    return {name: n_micro * n for name, n in each.items()}


def grad_guard(config):
    """One microbatch's loss gradients, every leaf, at ``config``'s train
    width and depth: through the kernels against the same with the grouped
    GEMM and the SSD scan (forward and backward) on their plain versions on
    the card, measured as the norm of the difference over the norm of the
    plain f32 gradients. In f32 (the same weights cast up) the two differ
    only by the kernels' summation order: within GRAD_F32_TOL. In bf16 both
    sit some 10 % from the f32 result after 48 Mamba layers (rounding
    through the layers, as the state guard's bf16 logits): the kernels'
    must be no farther from it than the plain versions' plus GUARD_TOL."""
    import gc
    import torch
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.kernels import ops
    from repro_torch.launch import profile_train
    from repro_torch.models import build_model
    from repro_torch.optim.adamw import tree_leaves, tree_map

    cfg, _ = profile_train.train_depth(config)
    shape, tcfg = profile_train.SHAPE, profile_train.train_config(config)
    m16 = build_model(cfg, "cuda")
    p16 = m16.init(torch.Generator("cuda").manual_seed(0))
    m32 = build_model(cfg.scaled(param_dtype="float32"), "cuda")
    p32 = tree_map(lambda t: t.float(), p16)
    n_micro = shape.global_batch // tcfg.microbatch_per_device
    batch = TokenPipeline(DataConfig(cfg.vocab, shape.seq_len, shape.global_batch,
                                     seed=0)).batch(0)
    mb = {k: torch.from_numpy(v).to("cuda")[0::n_micro] for k, v in batch.items()}
    on_cuda = ops._on_cuda
    # the kernels the path swaps: the grouped GEMM's or the SSD scan's, both ways
    swapped = ("moe_gmm", "moe_gmm_dx", "moe_gmm_dw") if cfg.family == "moe" else \
        ("ssd_scan", "ssd_scan_bwd")

    def plain_on_card(t, name):
        return name not in ("moe_gmm", "moe_gmm_bwd", "ssd_scan", "ssd_scan_bwd") and \
            on_cuda(t, name)

    def grads(model, params, plain):
        """The gradients, having checked that the kernel path launched each
        swapped kernel and the plain path none."""
        ops._on_cuda = plain_on_card if plain else on_cuda
        ops.reset_launch_counts()
        try:
            leaves = tree_map(lambda t: t.detach().requires_grad_(), params)
            loss, _ = model.loss(leaves, mb, tcfg.remat)
            out = torch.autograd.grad(loss, tree_leaves(leaves))
        finally:
            ops._on_cuda = on_cuda
        launched = {name: ops.launch_counts()[name] for name in swapped}
        if any(bool(n) == plain for n in launched.values()):
            fail(f"grad guard {config}: the {'plain' if plain else 'kernel'} path "
                 f"launched {launched}")
        return out

    ref = [g.float() for g in grads(m32, p32, True)]
    ref_sq = sum(float(g.square().sum()) for g in ref)

    def rel(gs):
        return (sum(float((g.float() - r).square().sum()) for g, r in zip(gs, ref))
                / ref_sq) ** 0.5

    out = {"f32_kernels": rel(grads(m32, p32, False))}
    out["bf16_plain"] = rel(grads(m16, p16, True))
    out["bf16_kernels"] = rel(grads(m16, p16, False))
    del ref, m16, p16, m32, p32
    gc.collect()
    torch.cuda.empty_cache()
    print(f"grad guard {config} (one microbatch, {cfg.n_layers} layers; gradients' "
          f"distance from the f32 plain versions', relative): {json.dumps(out)}")
    if not out["f32_kernels"] <= GRAD_F32_TOL:
        fail(f"grad guard {config}: f32 gradients through the kernels are "
             f"{out['f32_kernels']:.3g} from the plain versions' (tol {GRAD_F32_TOL})")
    if not out["bf16_kernels"] <= out["bf16_plain"] + GUARD_TOL:
        fail(f"grad guard {config}: bf16 gradients through the kernels are "
             f"{out['bf16_kernels']:.3g} from the f32 result, the plain versions' "
             f"{out['bf16_plain']:.3g}")
    return out


def train_phase(config="qwen1.5-0.5b"):
    """``config`` trained TRAIN_STEPS steps on one batch through
    ``profile_train.setup`` at the depth ``train_depth`` reckons: finite
    losses and grad norms, the last loss below the first, every kernel's
    launches split into equal steps of the counts remat gives, the rest
    launching nothing, and every bf16 launch on the tensor-core variants."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import profile_train

    cfg, reckoning = profile_train.train_depth(config)
    guard_rel = grad_guard(config) if cfg.family != "dense" else None
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, step, state, batch = profile_train.setup(seed=0, config=config)
    torch.cuda.synchronize()
    shape, tcfg = profile_train.SHAPE, profile_train.train_config(config)
    print(f"train: {cfg.name} full width, {reckoning['layers']} layers, "
          f"{model.n_params() / 1e6:.1f}M params, B={shape.global_batch} "
          f"S={shape.seq_len}, {tcfg}; set-up "
          f"{time.perf_counter() - t0:.1f} s; depth reckoning {json.dumps(reckoning)}")

    # ---- the main path: counts from 0, read right after ----
    ops.reset_launch_counts()
    losses, gnorms, step_ms, counts = [], [], [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(metrics["loss"]))
        gnorms.append(float(metrics["grad_norm"]))
        counts.append(ops.launch_counts())
    launches = ops.launch_counts()
    variants = {"flash_fwd": ops.flash_variant_counts(), **ops.flash_bwd_variant_counts(),
                "moe_gmm": ops.moe_gmm_variant_counts(), **ops.moe_gmm_bwd_variant_counts(),
                "ssd_scan": ops.ssd_scan_variant_counts(),
                "ssd_scan_bwd": ops.ssd_scan_bwd_variant_counts()}
    # ---- end of the main path ----

    n_micro = shape.global_batch // tcfg.microbatch_per_device
    expected = expected_train_launches(cfg, n_micro)
    for name in [k for k in launches if k not in expected]:   # not on this path
        if launches.pop(name) + sum(c.pop(name) for c in counts):
            fail(f"train: {name} launched while training {cfg.name}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if not all(math.isfinite(x) for x in losses + gnorms):
        fail(f"train {cfg.name}: non-finite loss or grad norm: {losses} {gnorms}")
    if not losses[-1] < losses[0]:
        fail(f"train {cfg.name}: the loss did not fall over {TRAIN_STEPS} steps: {losses}")
    limit = reckoning["peak_limit_gb"]
    if limit is not None and peak_gb > limit:
        fail(f"train {cfg.name}: peak memory {peak_gb:.3f} GB over the {limit} GB its "
             f"depth was reckoned for")
    per_step = {}
    for name, n in launches.items():
        steps = [counts[0][name]] + [counts[i][name] - counts[i - 1][name]
                                     for i in range(1, TRAIN_STEPS)]
        if n <= 0 or len(set(steps)) != 1:
            fail(f"kernel {name}: train launches {steps} do not split into "
                 f"{TRAIN_STEPS} equal steps")
        per_step[name] = steps[0]
    if per_step != expected:
        fail(f"train {cfg.name}: launches per step {per_step}, expected {expected}")
    # bf16 at S = 1024 (C = 320 tokens an expert): every forward on the
    # tensor-core prefill variants, every backward on its tensor-core
    # kernel; the others' variants launch nothing
    on = {"flash_fwd": "tc_prefill", "flash_bwd_dq": "tc", "flash_bwd_dkv": "tc",
          "moe_gmm": "tc_prefill", "moe_gmm_dx": "tc", "moe_gmm_dw": "tc",
          "ssd_scan": "tc", "ssd_scan_bwd": "tc"}
    for name, by_variant in variants.items():
        want = {v: (launches.get(name, 0) if v == on[name] else 0) for v in by_variant}
        if by_variant != want:
            fail(f"train {cfg.name}: {name} launches by variant {by_variant}, expected {want}")
    launches["by_variant"] = {name: v for name, v in variants.items() if name in expected}
    timed_ms = step_ms[1:]                       # after one warm-up step
    mean_ms = sum(timed_ms) / len(timed_ms)
    tokens = shape.global_batch * shape.seq_len
    print(f"train {cfg.name} losses {losses}, grad norms {gnorms}")
    print(f"train {cfg.name} step ms (host clock, synchronised; first is warm-up) "
          f"{step_ms}: mean {mean_ms:.3f} ms after warm-up, {tokens / mean_ms * 1e3:.1f} "
          f"trained tokens/s; peak memory {peak_gb:.3f} GB")
    print(f"launches: train path {launches} over {TRAIN_STEPS} steps; per step "
          f"{per_step} (expected from remat over {cfg.n_layers} layers x {n_micro} "
          f"microbatches: {expected})")
    return launches, per_step, {"step_ms": step_ms, "peak_gb": peak_gb, "losses": losses,
                                "reckoning": reckoning, "grad_guard": guard_rel}


def _cws_run(ckpt_dir, expected, label):
    """One run of the train launch, the launch counters set to 0 just before
    it and read just after: each step's launches must be ``expected`` (and
    no other kernel's), every attention launch on its tensor-core variant,
    every task of the workflow SUCCEEDED on its first attempt. → (the
    launch's result, its wall seconds, the run's launches)."""
    import torch
    from repro_torch.core.dag import TaskState
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch

    # ---- the main path: counts from 0, read right after ----
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = launch.train(**CWS_TRAIN, ckpt_dir=ckpt_dir, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    variants = {"flash_fwd": ops.flash_variant_counts(), **ops.flash_bwd_variant_counts()}
    # ---- end of the main path ----

    dag = out["workflow"]
    traces = out["runtime"].cws.provenance.traces_for_workflow(dag.workflow_id)
    bad = {t.task_id: (t.state.value, t.attempt) for t in dag.tasks.values()
           if t.state != TaskState.SUCCEEDED or t.attempt != 0}
    if bad or sorted(t.task_id for t in traces) != sorted(dag.tasks):
        fail(f"cws train {label}: tasks not all SUCCEEDED on their first attempt: {bad}, "
             f"{len(traces)} attempts recorded for {len(dag.tasks)} tasks")
    losses = [s["loss"] for s in out["steps"]]
    if not all(math.isfinite(x) for x in losses + [s["grad_norm"] for s in out["steps"]]):
        fail(f"cws train {label}: non-finite loss or grad norm: {out['steps']}")
    want = {name: expected.get(name, 0) for name in launches}
    before = dict.fromkeys(launches, 0)
    for s in out["steps"]:
        per = {name: s["launches"][name] - before[name] for name in launches}
        if per != want:
            fail(f"cws train {label}: step {s['step']} launched {per}, expected {want}")
        before = s["launches"]
    if before != launches:
        fail(f"cws train {label}: launches outside the steps: {launches} against {before}")
    on = {"flash_fwd": "tc_prefill", "flash_bwd_dq": "tc", "flash_bwd_dkv": "tc"}
    for name, by_variant in variants.items():
        if by_variant != {v: launches[name] if v == on[name] else 0 for v in by_variant}:
            fail(f"cws train {label}: {name} launches by variant {by_variant}")
    print(f"cws train {label}: from step {out['start_step']} ({out['resumed_from']}); "
          f"losses {losses}; wall {wall:.3f} s; checkpoint seconds "
          f"{json.dumps(out['checkpoints'])}")
    print(f"cws train {label} provenance (task, node, runtime s): " + json.dumps(
        [(t.task_id, t.node, t.runtime_s) for t in traces]))
    return out, wall, launches


def _step4_holds_step4(path):
    """``step_00000004`` holds one step's state, step 4's: its data step and
    optimizer step read 4 and every param is the bf16 of its master (the
    step ends with params = bf16(master), both updated in place)."""
    import numpy as np
    import torch
    with open(Path(path) / "manifest.json") as f:
        manifest = json.load(f)
    steps = [int(np.load(Path(path) / f"{k}.npy")) for k in ("data_step", "opt__step")]
    if manifest["step"] != 4 or steps != [4, 4]:
        fail(f"cws train: {path} holds data step and optimizer step {steps}, not 4")
    keys = [k for k in manifest["leaves"] if k.startswith("params__")]
    for key in keys:
        p = torch.from_numpy(np.load(Path(path) / f"{key}.npy").view(np.int16))
        master = torch.from_numpy(np.load(Path(path) / f"opt__master__{key[8:]}.npy"))
        if not torch.equal(master.to(torch.bfloat16).view(torch.int16), p):
            fail(f"cws train: {path}: {key} is not the bf16 of its master")
    print(f"cws train: {path} holds step 4 (data and optimizer step 4, {len(keys)} params "
          f"the bf16 of their master)")


def cws_train_phase(card):
    """Phase 6: qwen1.5-0.5b trained through the CWS by the train launch,
    checkpointed, then resumed from its own checkpoint at step 4 after
    ``step_00000008`` is lost. → (run A's launches, its per-step launches)."""
    import shutil
    import tempfile
    import torch
    from repro_torch.configs import get_config

    cfg = get_config(CWS_TRAIN["arch"])
    expected = expected_train_launches(cfg, n_micro=1)
    scratch = ROOT / "build"
    scratch.mkdir(exist_ok=True)
    free_gb = shutil.disk_usage(scratch).free / 1e9
    print(f"cws train: {free_gb:.3f} GB free on the checkpoints' disk ({scratch})")
    if free_gb < CKPT_MIN_FREE_GB:
        fail(f"cws train: {free_gb:.3f} GB free for the checkpoints, under "
             f"{CKPT_MIN_FREE_GB} GB (each is about 4.6 GB)")
    ckpt_dir = tempfile.mkdtemp(prefix="cws_train_ckpt_", dir=scratch)
    try:
        torch.cuda.reset_peak_memory_stats()
        a, wall_a, launches = _cws_run(ckpt_dir, expected, "run A")
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        del a["state"]
        la = {s["step"]: s["loss"] for s in a["steps"]}
        if not la[CWS_TRAIN["steps"]] < la[1]:
            fail(f"cws train run A: the loss did not fall: {la}")
        if sorted(a["checkpoints"]) != [4, 8]:
            fail(f"cws train run A: checkpoints at {sorted(a['checkpoints'])}, not 4 and 8")
        _step4_holds_step4(Path(ckpt_dir) / "step_00000004")
        chunk_s = [t.runtime_s for t in a["runtime"].cws.provenance.traces_for_name(
            "train_chunk")]
        lotaru = a["runtime"].predictor.predict("train_chunk", 0)
        timed = [s["seconds"] for s in a["steps"][1:]]          # after one warm-up step
        step_s = sum(timed) / len(timed)
        tokens = CWS_TRAIN["batch"] * CWS_TRAIN["seq"]
        print(f"cws train run A: step seconds (host clock, each ending in a read of "
              f"the loss; first is warm-up) {[s['seconds'] for s in a['steps']]}: mean "
              f"{step_s:.6f} s after warm-up, {1 / step_s:.4f} steps/s, "
              f"{tokens / step_s:.1f} trained tokens/s; whole workflow "
              f"{CWS_TRAIN['steps'] / wall_a:.4f} steps/s, "
              f"{CWS_TRAIN['steps'] * tokens / wall_a:.1f} tokens/s with the "
              f"checkpoints; peak memory {peak_gb:.3f} GB; {card}")
        print(f"cws train: Lotaru's train_chunk estimate after run A (mean, std) "
              f"{lotaru} s; the chunks took {chunk_s} s")
        shutil.rmtree(Path(ckpt_dir) / "step_00000008")
        release_memory("cws train run B")
        b, _, _ = _cws_run(ckpt_dir, expected, "run B")
        del b["state"]
        lb = {s["step"]: s["loss"] for s in b["steps"]}
        if b["start_step"] != 4 or sorted(lb) != [5, 6, 7, 8]:
            fail(f"cws train run B: resumed at step {b['start_step']} and trained "
                 f"{sorted(lb)}, not 5-8 from step 4")
        dloss = max(abs(lb[s] - la[s]) for s in lb)
        print(f"cws train: resumed steps 5-8, max |Δloss| {dloss} against run A "
              f"(tol {RESUME_TOL}); bit-identical: {all(lb[s] == la[s] for s in lb)}")
        if not dloss <= RESUME_TOL:
            fail(f"cws train: resumed losses {lb} are {dloss} from run A's {la}")
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    return launches, {name: n // CWS_TRAIN["steps"] for name, n in launches.items()}


def release_memory(next_phase):
    """Give the earlier phases' device memory back before the next model's
    phase (the MoE model's weights alone take 61.1 GB of the card's 80,
    gemma3-12b's 25.5 GB)."""
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated() / 1e9
    print(f"memory before {next_phase}: {held:.3f} GB allocated, "
          f"{torch.cuda.memory_reserved() / 1e9:.3f} GB reserved")
    if held > 1.0:
        fail(f"{held:.3f} GB still allocated before {next_phase}")


def main() -> int:
    card = device_phase()
    import torch
    build_phase()
    gen = torch.Generator("cuda").manual_seed(0)
    rms_err, rms_t = rmsnorm_phase(gen)
    flash_err, flash_t = flash_phase(gen)
    bwd_err, bwd_t = flash_bwd_phase(gen)
    gmm_err, gmm_t = gmm_phase(gen)
    ssd_err, ssd_t = ssd_phase(gen)
    gmm_bwd_err, gmm_bwd_t = gmm_bwd_phase(gen)
    ssd_bwd_err, ssd_bwd_t = ssd_bwd_phase(gen)
    launches, per_prefill, per_round = serve_phase()
    train_launches, per_step, _ = train_phase()
    release_memory("training through the CWS")
    cws_launches, cws_per_step = cws_train_phase(card)
    ssm = {}
    for config in SSM_CONFIGS:
        release_memory(config)
        ssm[config] = serve_phase(config)
    release_memory(MOE_CONFIG)
    moe_launches, moe_prefill, moe_round = serve_phase(MOE_CONFIG)
    release_memory(GEMMA3_CONFIG)
    gemma_launches, gemma_prefill, gemma_round = serve_phase(GEMMA3_CONFIG)
    trained = {}
    for config in TRAIN_CONFIGS:
        release_memory(f"training {config}")
        trained[config] = train_phase(config)

    def entry(name, source, replaces, err, timed):
        top = timed["prefill"]     # serving's launches below; "launches" is the train path's
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": train_launches[name], "max_abs_err": err,
                "ms": top["ms"], "plain_ms": top["plain_ms"],
                "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
                "library_ms": top["library_ms"], "wrapper_ms": top["wrapper_ms"],
                **{k: v for k, v in top.items() if k.endswith("warm_ms")},
                "shape": top["shape"], "decode": timed["decode"],
                "launches_per_train_step": per_step[name],
                "launches_serve": launches[name],
                "launches_per_prefill": per_prefill[name],
                "launches_per_decode_round": per_round[name],
                "moe_prefill": timed["moe_prefill"], "moe_decode": timed["moe_decode"],
                "launches_moe_serve": moe_launches[name],
                "launches_per_moe_prefill": moe_prefill[name],
                "launches_per_moe_decode_round": moe_round[name],
                "zamba2_prefill": timed["zamba2_prefill"],
                "zamba2_decode": timed["zamba2_decode"],
                "gemma3_prefill": timed["gemma3_prefill"],
                "gemma3_decode": timed["gemma3_decode"],
                "launches_gemma3_serve": gemma_launches[name],
                "launches_per_gemma3_prefill": gemma_prefill[name],
                "launches_per_gemma3_decode_round": gemma_round[name],
                **ssm_launches(name), **variant_launches(name),
                **train_launch_fields(name), **cws_launch_fields(name)}

    def variant_launches(name):
        """The forward flash kernel's launches by variant on each path."""
        if name != "flash_fwd":
            return {}
        paths = {"serve": launches, "moe_serve": moe_launches,
                 "gemma3_serve": gemma_launches,
                 **{f"{c}_serve": n for c, (n, _, _) in ssm.items()}}
        return {"launches_by_variant": {
            "train": train_launches["by_variant"]["flash_fwd"],
            **{path: n["flash_fwd_variants"] for path, n in paths.items()}}}

    def ssm_launches(name):
        """The kernel's launches on each SSM serving path it runs in."""
        out = {}
        for config, (n, pre, rnd) in ssm.items():
            if name in n:
                out.update({f"launches_{config}_serve": n[name],
                            f"launches_per_{config}_prefill": pre[name],
                            f"launches_per_{config}_decode_round": rnd[name]})
        return out

    def train_launch_fields(name):
        """The kernel's launches on each config's train path it runs in."""
        return {f"launches_{c}_train": {"total": n[name], "per_step": per[name],
                                        "by_variant": n["by_variant"].get(name)}
                for c, (n, per, _) in trained.items() if name in n}

    def cws_launch_fields(name):
        """The kernel's launches on the CWS-scheduled train path (run A)."""
        return {"launches_cws_train": {"total": cws_launches[name],
                                       "per_step": cws_per_step[name]}}

    def gmm_bwd_entry(name, err, timed):
        # top level: the MoE train microbatch's gate/up; "launches" is the
        # qwen3-moe-30b-a3b train path's
        return {**timed["train_gate_up"], "name": name, "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/moe_gmm.cu",
                "replaces": "src/repro/kernels/moe_gmm.py:21",
                "replaces_note": "the backward of the TPU kernel, which has none: JAX "
                                 "differentiates the expert einsum with XLA",
                "launches": trained[MOE_CONFIG][0][name], "max_abs_err": err,
                "paths": timed, **train_launch_fields(name)}

    def bwd_entry(name, line):
        # top level: the train step's shape; "paths" all four timed shapes
        return {"name": name, "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/flash_bwd.cu",
                "replaces": f"src/repro/kernels/flash_attention.py:{line}",
                "launches": train_launches[name], "max_abs_err": bwd_err[name],
                **bwd_t[name]["train"], "paths": bwd_t[name],
                "launches_by_variant": train_launches["by_variant"][name],
                "launches_per_train_step": per_step[name], **train_launch_fields(name),
                **cws_launch_fields(name)}

    kernels = [
        entry("flash_fwd", "src/repro_torch/kernels/csrc/flash_fwd.cu",
              "src/repro/kernels/flash_attention.py:28", flash_err, flash_t),
        bwd_entry("flash_bwd_dq", 170),
        bwd_entry("flash_bwd_dkv", 207),
        entry("rmsnorm", "src/repro_torch/kernels/csrc/rmsnorm.cu",
              "src/repro/kernels/rmsnorm.py:17", rms_err, rms_t),
        # top level: one gate/up call of a decode round, the path's most
        # frequent shape; "launches" is the MoE serving path's
        {**gmm_t["decode_gate_up"], "name": "moe_gmm", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/moe_gmm.cu",
         "replaces": "src/repro/kernels/moe_gmm.py:21",
         "launches": moe_launches["moe_gmm"], "max_abs_err": gmm_err, "paths": gmm_t,
         "launches_by_variant": moe_launches["moe_gmm_variants"],
         "launches_per_prefill": moe_prefill["moe_gmm"],
         "launches_per_decode_round": moe_round["moe_gmm"], **train_launch_fields("moe_gmm")},
        # top level: mamba2-370m's prefill step shape; "launches" is the
        # mamba2-370m serving path's
        {**ssd_t["mamba2_prefill"], "name": "ssd_scan", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
         "replaces": "src/repro/kernels/ssd_scan.py:26",
         "launches": ssm["mamba2-370m"][0]["ssd_scan"], "max_abs_err": ssd_err,
         "library_ms": None, "library": "none: no single PyTorch call computes an SSD scan",
         "paths": ssd_t, **ssm_launches("ssd_scan"), **train_launch_fields("ssd_scan"),
         "launches_by_variant": {f"{c}_serve": n["ssd_scan_variants"]
                                 for c, (n, _, _) in ssm.items()}},
        *(gmm_bwd_entry(name, gmm_bwd_err[name], gmm_bwd_t[name])
          for name in ("moe_gmm_dx", "moe_gmm_dw")),
        # top level: mamba2-370m's train microbatch on ``tc`` (the path's
        # variant); "launches" is its train path's; "variants" both kernels
        # at both train shapes
        {**ssd_bwd_t["tc"]["mamba2_train"], "name": "ssd_scan_bwd", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/ssd_scan_bwd.cu",
         "replaces": "src/repro/kernels/ssd_scan.py:26",
         "replaces_note": "the backward of the TPU kernel, which has none: JAX "
                          "differentiates ssd_chunked with XLA",
         "launches": trained["mamba2-370m"][0]["ssd_scan_bwd"], "max_abs_err": ssd_bwd_err,
         "max_abs_err_is": "relative to each output's largest value",
         "library_ms": None, "library": "none: no single PyTorch call computes an SSD scan",
         "variants": ssd_bwd_t, **train_launch_fields("ssd_scan_bwd")},
    ]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
