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
               320 and a D/F of no tile's width, the decode kernel at C =
               1, 2, 8, 15, 16 at qwen3-moe-30b-a3b's and mixtral-8x22b's
               widths, gate/up and down, and at ragged D/F under TMA's
               rule, each decode call twice and equal bit for bit, an
               expert of zero rows with a NaN in its w (NaN exactly where
               the plain version's is), mixtral at C = 160, 320, 1280, 1920
               (timed at 1 and 8, bound by reading w, cold and warm, and at
               1280, bound by its operations), its launches by variant
               checked (bf16 under TMA's rule on the decode kernel up to C
               = 16 and on the tensor-core kernel above, the rest on the
               wmma tile); RMSNorm also at d 4096, 3584 and 6144;
               the cases for those configs from a generator of their own
               (WIDE_SEED), so the earlier cases keep their draws; the SSD
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
               the GQA groups 16, 7 and 6 of chatglm3-6b, qwen2-7b and
               mixtral-8x22b (FLASH_WIDE_CASES: decode at 28:4, 32:2 and
               48:8, 32:2 at S = 2 and 3 on either side of the split-KV
               kernel's 32 rows, ragged prefill at 28:4, a window in both
               regimes at 48:8),
               every main path's shape (FLASH_PATHS: every family's
               prefill and decode, among them whisper-tiny's 1500-key
               non-causal encoder, its 448-token causal self prefill and
               cross prefill, its self decode at kv_len 1..448 and cross
               decode against 1500 keys with no kv_len, phi-3-vision-4.2b's
               576 patch rows and 1024 tokens at D = 96 and its decode
               rounds against 1632 and 2048 slots; chatglm3-6b's, qwen2-7b's
               and mixtral-8x22b's prefill step and decode round,
               mixtral's 6,144-token admission, where its window of 4096
               cuts every row past 4096, and a round against its full
               4096-slot ring), in f32 and bf16, with
               the launches by variant checked and a misaligned view
               refused, each main path also timed in bf16; the
               backward's two variants (tensor-core for bf16, FMA for f32)
               at every D with ragged S, windows and GQA up to 8:1, and at
               eleven timed shapes: the train step's, qwen3-moe's 32/4
               heads of 128, zamba2's 32 of 80, gemma3's 16/8 of 256 with
               its window, whisper's encoder, its decoder's causal
               self-attention (S = T = 448) and cross-attention
               (non-causal, S = 448 against T = 1500), phi-3-vision's 32
               heads of 96 over 1600 rows, chatglm3-6b's 32/2 and
               qwen2-7b's 28/4 of 128, gemma3's local layer at S = 2048,
               where its window of 1024 cuts (FLASH_BWD_WIDE_CASES: the
               group sums of 16, 7 and 6 heads); takes
               the device time (``torch.profiler``; CUDA events around
               the call where a profiler session records no device
               event, counted and printed at the end) of the kernel, of the
               plain version and of one PyTorch library call of the same
               function where there is one (a yardstick only: the port never
               calls it; a window narrower than S goes to SDPA as a band
               mask; no PyTorch call computes an SSD scan), and
               the kernel's call time through its wrapper. The backward
               kernels take O and lse from the forward kernel. The
               grouped GEMM's backward (dX = dy·wᵀ, dW = bufᵀ·dy) in f32
               and bf16 at C = 1, 8, 17, 40, 320, and at mixtral-8x22b's
               widths (E 8, D 6144, F 16384) at C = 8, 320, 1280, with D
               or F no multiple of 8 and a misaligned base (the wmma
               tile), at the tc kernels' edges (GMM_BWD_EDGE: one K step
               with N one tile, C = 40, 64, 65, 127, 128, 320, D and F of
               64, 256 and 264), every bf16 call twice and equal bit for
               bit, its launches by variant checked, timed warm and with
               L2 flushed at the MoE train microbatches (gate/up and down,
               C = 320 and 1280) beside ``torch.bmm``; the SSD backward
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
 10. serve VLM — after the earlier phases' memory is given back, phase 4
               on full-width, full-depth phi-3-vision-4.2b (32 layers, 32
               heads of 96, 3.82 B parameters in bf16 from seed 0): the
               prefill step takes 576 patch rows (``synthetic_extras``, f32,
               cast by the model) before the 1024 tokens, into a cache with
               room for VLM_ROUNDS greedy decode rounds from position 1600,
               which follow it on the main path; then the text-only burst.
               Per prefill and per round flash_fwd 32, rmsnorm 65; the
               cross-slot guard; a decode guard: the rounds' logits against
               the teacher-forced forward over the same tokens and patches
               (``decode_guard``: in f32 within DECODE_F32_TOL, in bf16
               no farther from the f32 forward than DECODE_BF16_RATIO
               times the bf16 forward is; a replay planted one position
               off must exceed each limit).
 11. serve audio — full-width, full-depth whisper-tiny (4 encoder and 4
               decoder layers, 6 heads of 64): the prefill step (the
               forward over 4 x 448 tokens and 1500 frames) twice, then 8
               clips of 1500 frames through ``encdec_serve_cache`` and 448
               decode steps (4 prompt tokens, then greedy). Per prefill
               flash_fwd 12, rmsnorm 22; per cache fill 4, 9; per decode
               round 8, 13; prefills and fill on ``tc_prefill``, rounds on
               ``split_decode``; the decode guard as in phase 10.
 12. serve the wide configs — after the earlier phases' memory is given
               back, phase 4 (with the cross-slot guard) on full-width,
               full-depth chatglm3-6b (28 layers, GQA 32:2, half-head RoPE,
               QKV bias: 6.24 B parameters) and qwen2-7b (28 layers, 28:4,
               QKV bias, θ 1e6: 7.62 B), each also decoding VLM_ROUNDS
               rounds from its prefill step's cache under the decode guard
               (its f32 copy, 25.0 and 30.5 GB, fits beside the bf16
               weights); flash_fwd 28 and rmsnorm 57 launches per prefill
               and per round. Then mixtral-8x22b at full width and 12 of
               its 56 layers (30.45 B parameters, 60.9 GB, as much as
               qwen3-moe's full depth; 8 experts top-2, 48:8, window 4096):
               flash_fwd 12, rmsnorm 25, moe_gmm 36 per prefill and round,
               prefills' gmm on ``tc_prefill``, rounds' on ``decode``; no
               decode guard (past 256 tokens the forward drops tokens at
               capacity and decode does not: ROADMAP C5); then
               ``long_admission``: one 6,144-token prefill into an
               8192-slot cache (4096-slot rings: the window cuts the
               prefill's attention, the gmm runs at C = 1920, the ring
               keeps positions 2048..6143 by ``_to_cache_slots``' roll) and
               32 rounds that wrap the ring, finite logits, layer 0's K
               ring against K recomputed from the normed embeddings at pos
               % 4096 within RING_TOL of its largest value, a ring rolled
               one slot failing that check. Last ``ring_guard_phase``:
               gemma3-12b at 12 of 48 layers (two 5:1 groups, 4.70 B: the
               decode guard's f32 copy of all 48 layers, 51 GB, does not
               fit beside the bf16 weights, 18.8 GB of 12 does) through a
               one-slot batcher of 2048 slots, a 1,536-token prompt past
               its 1024-slot local rings and 64 rounds that wrap them,
               under the decode guard (planted fault included).
 13. train MoE, SSM, hybrid, VLM, audio and the wide configs — after the
               earlier phases' memory
               is given back, phase 5 on qwen3-moe-30b-a3b (full width, 4 of
               48 layers: 3.11 B parameters, ~50 GB of train state at 16
               bytes a parameter; the peak must stay within 72 GB), then
               full-width, full-depth mamba2-370m and zamba2-2.7b (the
               peak within 75 GB), phi-3-vision-4.2b (16 of 32 layers: 2.01
               B parameters, ~32 GB of state; 576 patches before 1024
               tokens; within 72 GB) and whisper-tiny (full depth, 448
               tokens against 1500 frames), chatglm3-6b (14 of 28 layers,
               3.39 B, ~54 GB of state; within 74 GB), qwen2-7b (10 of 28,
               3.42 B, ~55 GB; 74), mixtral-8x22b (1 of 56, 2.91 B, ~46.5
               GB; 68: its dX and dW at C = 1280) and gemma3-12b (6 of 48,
               one 5:1 group, 3.36 B, ~54 GB; 78; B=4, S=2048 in two
               microbatches of 2, so its window of 1024 cuts the forward
               and the backward), each through
               ``profile_train.setup(config=...)``. Per step, from remat
               over L layers and 2 microbatches: MoE moe_gmm 12·L,
               moe_gmm_dx 6·L, moe_gmm_dw 6·L and the flash kernels as the
               dense step; mamba2 ssd_scan 4·48, ssd_scan_bwd 2·48, no
               attention; zamba2 as mamba2 over its 54 Mamba layers plus
               the shared block's 9 flash launches each way; phi-3-vision
               as the dense step; whisper's encoder (not recomputed) once
               each way and its decoder layers' two attentions and three
               norms. Every bf16
               forward gmm launch on ``tc_prefill``, every SSD forward and
               backward on ``tc``, every other backward on its tensor-core
               kernel; step time and
               peak memory printed. Before each, a gradient guard: one
               microbatch's loss gradients through the kernels against the
               same through the plain versions of the family's kernels on
               the card (the grouped GEMM's, the SSD scan's, or, for the
               dense, VLM and audio configs, the flash attention's and
               RMSNorm's), within GRAD_F32_TOL of their
               norm in f32 and, in bf16, no farther from the f32 result
               than the plain versions' plus GUARD_TOL.
 14. mesh    — after the earlier phases' memory is given back, the host
               mesh (``launch.mesh.make_host_mesh``: a (1, 1) ("data",
               "model") DeviceMesh over NCCL in a world of one, from an
               in-process store) and phase 5's train step on it, the state
               placed by ``make_train_step``'s shardings (params by the
               train rules, AdamW state by ZeRO-1) as DTensors, the kernels
               reached through ``local_map``: 4 steps, then 4 with
               ``mesh=None`` from the same seed; every loss and every leaf
               must be bit-identical, the launches per step phase 5's.
               Step 2 runs under ``torch.profiler`` for its device time
               (its span between CUDA events if the profiler records none);
               the host ms of both runs are printed. Then int8 compression
               of step 1's f32 gradient tree (error feedback from a zero
               residual: deq + residual within one f32 ulp of each leaf's
               scale of g; the pod all-reduce over the 1-rank "pod" group
               of a (1, 1, 1) mesh equal to dequantize(quantize(g))), both
               timed with CUDA events; the mesh state after step 4 saved
               and restored onto the mesh's shardings, bit-identical;
               ``analysis.analytic_cell``'s compute and memory terms at
               the H100 constants against step 2's device time
               (``roofline_frac`` finite, above 0 and at most
               ROOFLINE_MAX); last, ``make_prefill_step`` at B=4, S=1024
               and MESH_DECODE_STEPS ``make_serve_step`` steps on the mesh,
               the same tokens and launches as with ``mesh=None``.
 15. report  — the card's nvidia-smi line, one JSON line with every kernel's
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
DECODE_F32_TOL = 1e-4                             # decode vs forward, f32, of max |logit|
DECODE_BF16_RATIO = 1.25                          # bf16 decode vs the f32 forward:
                                                  # at most this x the bf16 forward's
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
# GQA groups no case above has: decode at S = 1 against T = 300 at 28:4,
# 32:2 and 48:8 (7, 16 and 6 rows a KV head: a dead row, two row groups,
# two dead rows); 32:2 at S = 2 (32 rows: the split-KV kernel's edge) and S
# = 3 (48 rows: the tensor-core prefill kernel); ragged prefill at 28:4; a
# window in both regimes at 48:8
FLASH_WIDE_CASES = [
    (8, 1, 300, 28, 4, 128, False, 0, DECODE_LENS), (8, 1, 300, 32, 2, 128, False, 0, DECODE_LENS),
    (8, 1, 300, 48, 8, 128, False, 0, DECODE_LENS), (2, 2, 300, 32, 2, 128, False, 0, [300, 77]),
    (2, 3, 300, 32, 2, 128, True, 0, None), (2, 3, 300, 32, 2, 128, False, 0, [300, 129]),
    (2, 37, 37, 28, 4, 128, True, 0, None), (2, 300, 300, 28, 4, 128, True, 0, None),
    (2, 4, 300, 48, 8, 128, True, 2, [300, 150]), (2, 300, 300, 48, 8, 128, True, 64, None)]
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
# and the dk/dv group sums of 7, 16 and 6 heads (a window at 48:8)
FLASH_BWD_WIDE_CASES = [(300, 300, 28, 4, 128, True, 0), (129, 129, 32, 2, 128, True, 0),
                        (300, 300, 48, 8, 128, True, 64)]
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
# the decode kernel's cases, drawn from a generator of their own
# (DECODE_SEED) so that every case before them keeps its draws: the tokens
# per expert it takes (C <= 16), each at qwen3-moe's and mixtral-8x22b's
# widths, gate/up and down; (E, C, D, F) under TMA's rule with D and F of no
# tile's width (128 F columns, 128 D rows a step); and GMM_WMMA_CASES' kinds
# at C <= 16, which the wmma tile serves too
GMM_DECODE_C = (1, 2, 8, 15, 16)
GMM_DECODE_RAGGED = [(3, 5, 200, 72), (4, 16, 136, 264)]
GMM_DECODE_WMMA_CASES = [(4, 8, 2048, 768, 1, 0), (4, 1, 768, 2048, 0, 1),
                         (4, 8, 2044, 768, 0, 0), (3, 16, 200, 76, 0, 0)]
DECODE_SEED = 5
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
# mixtral-8x22b's experts (E, D, F): tokens per expert at the decode
# kernel's GMM_DECODE_C (one slot, a decode round of 8 slots), a 512-token
# admission, a 1024-token one, a B=4 x S=1024 prefill step or train
# microbatch, the 6,144-token admission (C = round(T·2/8·1.25) past 256
# tokens); the forward timed at C = 1 (the long admission's rounds), 8 and
# 1280, the backward checked at GMM_BWD_WIDE_C and timed at 1280
GMM_WIDE = (8, 6144, 16384)
GMM_WIDE_C = (1, 8, 160, 320, 1280, 1920)
GMM_WIDE_TIMED = {"mixtral_one_slot": 1, "mixtral_decode": 8, "mixtral_prefill": 1280}
GMM_BWD_WIDE_C = (8, 320, 1280)
GMM_BWD_WMMA_CASES = [(3, 100, 200, 76, 0, 0), (4, 40, 2044, 768, 0, 0),
                      (4, 17, 768, 2048, 1, 0), (4, 40, 2048, 768, 0, 1)]
# the tc backward kernel's edges (E, C, D, F), from a generator of their
# own (EDGE_SEED): one 64-deep K step with N one 256-column tile (dX at C =
# 40 and 64, dW at C = 64), C = 64, 65, 127, 128 and 320 around dW's
# 64-deep steps and within dX's 320-token tile, D and F of 64, 256 and 264
GMM_BWD_EDGE = [(4, 40, 256, 64), (2, 64, 256, 64), (2, 64, 64, 256), (2, 65, 64, 256),
                (2, 127, 264, 256), (2, 128, 256, 264), (2, 320, 64, 264), (3, 320, 264, 64)]
EDGE_SEED = 11
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
TRAIN_CONFIGS = ("qwen3-moe-30b-a3b", "mamba2-370m", "zamba2-2.7b", "phi-3-vision-4.2b",
                 "whisper-tiny", "chatglm3-6b", "qwen2-7b", "mixtral-8x22b", "gemma3-12b")
# served in phase 12 at full width, at these depths (None: all layers):
# mixtral-8x22b's 12 of 56 layers hold 30.45 B parameters, 60.9 GB in bf16
WIDE_SERVE = {"chatglm3-6b": None, "qwen2-7b": None, "mixtral-8x22b": 12}
# the dense configs whose decode rounds from the prefill step's cache (as
# many as a VLM's) go under the decode guard: half-head RoPE, the QKV bias
# and GQA 16:1 and 7:1 in decode
DECODE_GUARDED = ("chatglm3-6b", "qwen2-7b")
# mixtral-8x22b's long admission: a prompt of LONG_PROMPT tokens into a
# cache of LONG_MAX_LEN slots, so that each layer's ring holds its window of
# 4096 and the prompt's first 2048 positions fall out of it; then
# LONG_ROUNDS decode rounds, which write around the ring
LONG_CONFIG = "mixtral-8x22b"
LONG_PROMPT, LONG_MAX_LEN, LONG_ROUNDS = 6144, 8192, 32
# gemma3-12b's ring guard: a cut of 12 of its 48 layers (two 5:1 groups,
# 4.70 B parameters) through a one-slot batcher of RING_MAX_LEN slots, one
# request of RING_PROMPT tokens (past the local layers' ring of 1024) and
# RING_ROUNDS decode rounds
RING_LAYERS, RING_PROMPT, RING_ROUNDS, RING_MAX_LEN = 12, 1536, 64, 2048
RING_TOL = 2e-2                                   # a ring's K rows, of their largest
# the cases added for those configs' shapes draw from a generator of their
# own, seeded here, so that every case before them keeps its draws
WIDE_SEED = 3
MOE_CONFIG = "qwen3-moe-30b-a3b"
GEMMA3_CONFIG = "gemma3-12b"
VLM_CONFIG = "phi-3-vision-4.2b"
VLM_ROUNDS = 32               # greedy decode rounds from the VLM prefill's cache
AUDIO_CONFIG = "whisper-tiny"
# the forward's main-path shapes, each timed in bf16 and checked beside
# FLASH_CASES in f32 and bf16 (B, S, T, Hq, Hkv, D, causal, window, kv_len):
# kv_len (lo, hi) spreads the rows' lengths evenly over lo..hi, None lets
# every row attend to all T keys.
#   qwen1.5-0.5b: S = T = 1024, 16 heads of 64; decode B=8 against 2048 slots
#   qwen3-moe-30b-a3b: GQA 8:1, 32 query and 4 KV heads of 128
#   zamba2-2.7b's shared block: 32 heads of 80
#   gemma3-12b: 16 query and 8 KV heads of 256; a local layer's window of
#     1024 (at S = 1024 every causal key lies inside it)
#   whisper-tiny: the encoder over 1500 frames; the decoder's causal
#     self-attention over 448 tokens and its cross-attention to 1500 frames,
#     in a prefill and in a decode step (self: each row's pos + 1 of 448 slots)
#   phi-3-vision-4.2b: the prefill of 576 patch rows and 1024 tokens; the
#     VLM_ROUNDS decode rounds after it (B=4, 1632 slots, kv_len 1601..1632)
#     and the burst's (B=8, 2048 slots)
FLASH_PATHS = {
    "prefill": (4, 1024, 1024, 16, 16, 64, True, 0, None),
    "decode": (8, 1, 2048, 16, 16, 64, False, 0, (1, 2048)),
    "moe_prefill": (4, 1024, 1024, 32, 4, 128, True, 0, None),
    "moe_decode": (8, 1, 2048, 32, 4, 128, False, 0, (1, 2048)),
    "zamba2_prefill": (4, 1024, 1024, 32, 32, 80, True, 0, None),
    "zamba2_decode": (8, 1, 2048, 32, 32, 80, False, 0, (1, 2048)),
    "gemma3_prefill": (4, 1024, 1024, 16, 8, 256, True, 1024, None),
    "gemma3_decode": (8, 1, 2048, 16, 8, 256, False, 0, (1, 2048)),
    "whisper_encoder": (4, 1500, 1500, 6, 6, 64, False, 0, None),
    "whisper_self_prefill": (4, 448, 448, 6, 6, 64, True, 0, None),
    "whisper_cross_prefill": (4, 448, 1500, 6, 6, 64, False, 0, None),
    "whisper_self_decode": (8, 1, 448, 6, 6, 64, False, 0, (1, 448)),
    "whisper_cross_decode": (8, 1, 1500, 6, 6, 64, False, 0, None),
    "phi3v_prefill": (4, 1600, 1600, 32, 32, 96, True, 0, None),
    "phi3v_decode": (4, 1, 1632, 32, 32, 96, False, 0, (1601, 1632)),
    "phi3v_burst_decode": (8, 1, 2048, 32, 32, 96, False, 0, (1, 2048)),
}
# chatglm3-6b: 32 query and 2 KV heads of 128; qwen2-7b: 28 and 4;
# mixtral-8x22b: 48 and 8, a window of 4096 (at S = 1024 it cuts nothing;
# its decode attends a ring as a full cache, with no window), its long
# admission (S = T = 6144: the window cuts every row past 4096) and a round
# after it (every one of the ring's 4096 slots valid)
FLASH_WIDE_PATHS = {
    "chatglm3_prefill": (4, 1024, 1024, 32, 2, 128, True, 0, None),
    "chatglm3_decode": (8, 1, 2048, 32, 2, 128, False, 0, (1, 2048)),
    "qwen2_prefill": (4, 1024, 1024, 28, 4, 128, True, 0, None),
    "qwen2_decode": (8, 1, 2048, 28, 4, 128, False, 0, (1, 2048)),
    "mixtral_prefill": (4, 1024, 1024, 48, 8, 128, True, 4096, None),
    "mixtral_decode": (8, 1, 2048, 48, 8, 128, False, 0, (1, 2048)),
    "mixtral_long_prefill": (1, 6144, 6144, 48, 8, 128, True, 4096, None),
    "mixtral_ring_decode": (1, 1, 4096, 48, 8, 128, False, 0, (4096, 4096)),
}
FLASH_PATHS.update(FLASH_WIDE_PATHS)
# the CWS-scheduled train launch: full-width qwen1.5-0.5b in one microbatch
# of 8 x 1024, a checkpoint task every 4 steps, profile_train's dense peak
# learning rate (the launch's own 3e-3 is untried at this width)
CWS_TRAIN = dict(arch="qwen1.5-0.5b", steps=8, chunk=2, batch=8, seq=1024,
                 ckpt_every=4, lr=1e-3)
CKPT_MIN_FREE_GB = 16.0       # two 4.6 GB checkpoints, a rewrite and room
RESUME_TOL = 5e-2             # max |Δloss| of the resumed steps
# the backward's timed shapes (B, S, T, Hq, Hkv, D, causal, window): the
# train step's microbatch (qwen1.5-0.5b), qwen3-moe-30b-a3b's heads,
# zamba2-2.7b's shared block, a gemma3-12b local layer, whisper-tiny's
# encoder, its decoder's causal self-attention over 448 tokens and its
# cross-attention (448 decoder tokens against 1500 frames, non-causal),
# phi-3-vision-4.2b's 576 patch rows and 1024 tokens
BWD_PATHS = {"train": (4, 1024, 1024, 16, 16, 64, True, 0),
             "moe": (4, 1024, 1024, 32, 4, 128, True, 0),
             "zamba2": (4, 1024, 1024, 32, 32, 80, True, 0),
             "gemma3": (4, 1024, 1024, 16, 8, 256, True, 1024),
             "whisper_encoder": (4, 1500, 1500, 6, 6, 64, False, 0),
             "whisper_self": (4, 448, 448, 6, 6, 64, True, 0),
             "whisper_cross": (4, 448, 1500, 6, 6, 64, False, 0),
             "phi3v": (4, 1600, 1600, 32, 32, 96, True, 0)}
# chatglm3-6b's and qwen2-7b's train microbatch, and a gemma3-12b local
# layer at its train shape (S = 2048: the window cuts every row past 1024)
BWD_WIDE_PATHS = {"chatglm3": (4, 1024, 1024, 32, 2, 128, True, 0),
                  "qwen2": (4, 1024, 1024, 28, 4, 128, True, 0),
                  "gemma3_local_2k": (2, 2048, 2048, 16, 8, 256, True, 1024)}
BWD_PATHS.update(BWD_WIDE_PATHS)


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
    tile = min(tile, S)    # S under a tile (a gmm's 8 experts): one tile, no padding
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
    # gated norm, then gemma3-12b's, whisper-tiny's encoder (4 clips of 1500
    # frames) and decode round (8 clips), phi-3-vision-4.2b's prefill (4 x
    # 1600 rows) and decode round (4 rows)
    shape_by_path = {"prefill": (4 * 1024, 1024), "decode": (8, 1024),
                     "moe_prefill": (4 * 1024, 2048), "moe_decode": (8, 2048),
                     "zamba2_prefill": (4 * 1024, 5120), "zamba2_decode": (8, 5120),
                     "gemma3_prefill": (4 * 1024, 3840), "gemma3_decode": (8, 3840),
                     "whisper_encoder": (4 * 1500, 384), "whisper_decode": (8, 384),
                     "phi3v_prefill": (4 * 1600, 3072), "phi3v_decode": (4, 3072)}
    # then chatglm3-6b's, qwen2-7b's and mixtral-8x22b's prefill step and
    # decode round, from their own generator
    wide = torch.Generator("cuda").manual_seed(WIDE_SEED)
    wide_by_path = {"chatglm3_prefill": (4 * 1024, 4096), "chatglm3_decode": (8, 4096),
                    "qwen2_prefill": (4 * 1024, 3584), "qwen2_decode": (8, 3584),
                    "mixtral_prefill": (4 * 1024, 6144), "mixtral_decode": (8, 6144)}
    timed = {}
    for path, (rows, d), g in [(p, shape, gen) for p, shape in shape_by_path.items()] + \
            [(p, shape, wide) for p, shape in wide_by_path.items()]:
        x = torch.randn(rows, d, generator=g, device="cuda").to(torch.bfloat16)
        s = (1 + 0.1 * torch.randn(d, generator=g, device="cuda")).to(torch.bfloat16)
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
    main-path shapes (FLASH_PATHS, among them whisper-tiny's 1500-key
    non-causal tail and cross decode with no kv_len), the variants' cases
    (FLASH_VARIANT_CASES), q/k/v split from one fused projection, K/V as
    views of a stacked and of a fused cache, each in f32 (the FMA kernel)
    and bf16 (tensor-core prefill or split-KV decode); the variant counts
    must match the shapes, FMA only for f32; a misaligned bf16 view must be
    refused. Then the main-path shapes, timed."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    worst = 0.0
    ops.reset_launch_counts()
    want = {"tc_prefill": 0, "split_decode": 0, "fma": 0}
    wide = torch.Generator("cuda").manual_seed(WIDE_SEED)

    def randn(*shape, dt, g=gen):
        return torch.randn(shape, generator=g, device="cuda").to(dt)

    for dt in (torch.float32, torch.bfloat16):
        cases = [(gen, 2, S, T, Hq, Hkv, D, c, w, None)
                 for (S, T, Hq, Hkv, D, c, w) in FLASH_CASES]
        cases += [(gen, *shape, _spread(shape[0], lens))
                  for path, (*shape, lens) in FLASH_PATHS.items() if path not in FLASH_WIDE_PATHS]
        cases += [(gen, *case) for case in FLASH_VARIANT_CASES]
        cases += [(wide, *shape, _spread(shape[0], lens))
                  for (*shape, lens) in FLASH_WIDE_PATHS.values()]
        cases += [(wide, *case) for case in FLASH_WIDE_CASES]
        for (g, B, S, T, Hq, Hkv, D, causal, window, lens) in cases:
            q, k, v = randn(B, S, Hq, D, dt=dt, g=g), randn(B, T, Hkv, D, dt=dt, g=g), \
                randn(B, T, Hkv, D, dt=dt, g=g)
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

    timed = {path: _flash_path(path, wide if path in FLASH_WIDE_PATHS else gen, *spec)
             for path, spec in FLASH_PATHS.items()}
    for t in timed.values():
        worst = max(worst, t["max_abs_err"])
    return worst, timed


def _causal_pairs(S, window):
    """Valid (query, key) pairs of one causal S x S head under ``window``."""
    return sum(min(q + 1, window) if window > 0 else q + 1 for q in range(S))


def _spread(B, lens):
    """A main-path kv_len (lo, hi) → B per-row lengths spread evenly over
    lo..hi; None stays None."""
    import torch
    return None if lens is None else \
        torch.linspace(lens[0], lens[1], B).round().int().tolist()


def _flash_path(path, gen, B, S, T, Hq, Hkv, D, causal, window, lens):
    """The forward kernel at one FLASH_PATHS shape (bf16): checked against
    the plain version, device times of kernel, plain and SDPA, wrapper time
    and the bound. A causal path is a prefill (a window of at least S
    changes nothing, so SDPA's causal call computes the same; a narrower
    one goes to SDPA as a band mask); a non-causal one attends to each
    row's kv_len keys (``_spread(B, lens)``) or, with none, to all T."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (
        _mask, flash_attention_cuda, flash_attention_plain)
    from repro_torch.launch.kernel_times import device_ms, wrapper_ms
    bf16 = torch.bfloat16
    q = torch.randn(B, S, Hq, D, generator=gen, device="cuda").to(bf16)
    k, v = (torch.randn(B, T, Hkv, D, generator=gen, device="cuda").to(bf16)
            for _ in range(2))
    if (causal and lens is not None) or (window and not causal):
        fail(f"flash {path}: a causal path takes no kv_len, a non-causal one no window")
    kv_len = None if lens is None else torch.tensor(_spread(B, lens), dtype=torch.int32,
                                                    device="cuda")
    shape = (f"B={B} S={S} T={T} Hq={Hq} Hkv={Hkv} D={D} "
             f"{'causal' if causal else 'non-causal'}{f' window {window}' if window else ''}"
             f"{f' kv_len {lens[0]}..{lens[1]}' if lens else ''} bf16")
    o, lse, po, plse = _flash_pair(q, k, v, causal, window, kv_len)
    err = max(compare(f"flash {path} O", o, po, TOL["bfloat16"]),
              compare(f"flash {path} lse", lse, plse, LSE_TOL))
    # bytes: q and O, the K/V each row may see, lse (and kv_len); operations:
    # 4·D per valid (query, key) pair
    if causal:
        pairs, kv_bytes = B * Hq * _causal_pairs(S, window), 2 * B * T * Hkv * D * 2
    elif kv_len is not None:
        valid = int(kv_len.sum())
        pairs, kv_bytes = S * Hq * valid, 2 * valid * Hkv * D * 2 + B * 4
    else:
        pairs, kv_bytes = B * Hq * S * T, 2 * B * T * Hkv * D * 2
    b_ms, b_by = bound(2 * B * S * Hq * D * 2 + kv_bytes + B * Hq * S * 4,
                       4.0 * D * pairs, PEAK_BF16_FLOPS)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    gqa = {"enable_gqa": True} if Hq != Hkv else {}
    if window and window < S:
        band = _mask(S, T, causal, window, "cuda")

        def library():
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=band, **gqa)
    elif kv_len is None:
        def library():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal, **gqa)
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
            q, k, v, causal=causal, window=window, kv_len=kv_len), iters=5 if S > 4 else 20),
        "library_ms": device_ms(library), "bound_ms": b_ms, "bound_by": b_by}
    print(f"flash_fwd {path}: {json.dumps(timed)}")
    return timed


def gmm_phase(gen):
    """The grouped expert GEMM against its plain version: the JAX test cases
    (f32 and bf16, tests/test_kernels.py's tolerances), ragged C at
    qwen3-moe-30b-a3b's widths and a D/F of no tile's width (f32 and bf16),
    the decode kernel at GMM_DECODE_C (qwen3-moe's widths, gate/up and down)
    and GMM_DECODE_RAGGED, every decode call made twice and held equal bit
    for bit, an expert of all-zero rows with a NaN in its w (0 · NaN = NaN,
    as in the plain version and the Pallas kernel: the output must be NaN
    exactly where the plain version's is), the bf16 cases that TMA cannot
    read (GMM_WMMA_CASES: a misaligned base, D or F no multiple of 8; and
    GMM_DECODE_WMMA_CASES, the same kinds at C <= 16), the main-path shapes
    of one MoE layer (bf16, gate/up and down at C = 8, 40, 256, 320), which
    are also timed, and mixtral-8x22b's (bf16, GMM_WIDE at GMM_WIDE_C and
    GMM_DECODE_C, timed at GMM_WIDE_TIMED: the decode rounds', bound by
    reading w, and the prefill step's, bound by its operations); each timed
    decode shape also cold (L2 flushed), beside ``torch.bmm`` likewise.
    Every launch's variant must be the one TMA's rule names for its shape
    and bases: bf16 under the rule on ``decode`` up to C = 16 and on
    ``tc_prefill`` above, the two lists of wmma cases all on ``wmma``. The
    decode kernel's cases draw from a generator of their own (DECODE_SEED),
    so the earlier cases keep their draws."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.moe_gmm import DECODE_MAX_C, _variant, moe_gmm_cuda, moe_gmm_plain
    from repro_torch.launch.kernel_times import (
        MOE_C, MOE_D, MOE_E, MOE_F, device_ms, wrapper_ms)

    def inputs(E, C, D, F, dt, w_std, g=gen):
        buf = torch.randn(E, C, D, generator=g, device="cuda").to(dt)
        return buf, (w_std * torch.randn(E, D, F, generator=g, device="cuda")).to(dt)

    want = dict.fromkeys(ops.moe_gmm_variant_counts(), 0)

    def launch(name, buf, w, tma):
        """One call on the variant TMA's rule (``tma``: the case meets it)
        names; a decode call twice, equal bit for bit."""
        C, D, F = buf.shape[1], buf.shape[2], w.shape[2]
        variant = _variant(buf.dtype, C, D, F,
                           buf.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0)
        rule = "wmma" if not tma else "decode" if C <= DECODE_MAX_C else "tc_prefill"
        if buf.dtype == torch.bfloat16 and variant != rule:
            fail(f"{name}: bf16 C = {C} would take {variant}, not {rule}")
        got = moe_gmm_cuda(buf, w)
        want[variant] += 1
        if variant == "decode":
            again = moe_gmm_cuda(buf, w)
            want[variant] += 1
            torch.cuda.synchronize()
            if not torch.equal(got.view(torch.int16), again.view(torch.int16)):
                fail(f"{name}: two decode calls on the same inputs differ")
        return got

    def check(name, buf, w, atol, rtol=None, tma=True):
        return compare(name, launch(name, buf, w, tma), moe_gmm_plain(buf, w), atol, rtol)

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
    dec = torch.Generator("cuda").manual_seed(DECODE_SEED)
    for C in GMM_DECODE_C:
        for part, (D, F) in (("gate_up", (MOE_D, MOE_F)), ("down", (MOE_F, MOE_D))):
            buf, w = inputs(MOE_E, C, D, F, torch.bfloat16, D ** -0.5, dec)
            worst = max(worst, check(f"moe_gmm decode {part} {(MOE_E, C, D, F)}", buf, w,
                                     TOL["bfloat16"]))
    for (E, C, D, F) in GMM_DECODE_RAGGED:
        buf, w = inputs(E, C, D, F, torch.bfloat16, D ** -0.5, dec)
        worst = max(worst, check(f"moe_gmm decode ragged {(E, C, D, F)}", buf, w,
                                 TOL["bfloat16"]))
    for (E, C, D, F, b_off, w_off) in GMM_DECODE_WMMA_CASES:
        flat_buf = torch.randn(b_off + E * C * D, generator=dec, device="cuda")
        flat_w = D ** -0.5 * torch.randn(w_off + E * D * F, generator=dec, device="cuda")
        buf = flat_buf.to(torch.bfloat16)[b_off:].view(E, C, D)
        w = flat_w.to(torch.bfloat16)[w_off:].view(E, D, F)
        worst = max(worst, check(f"moe_gmm wmma {(E, C, D, F)} offsets {(b_off, w_off)}",
                                 buf, w, TOL["bfloat16"], tma=False))
    # expert 3 got no token (all-zero rows) and holds a NaN in its w
    buf, w = inputs(MOE_E, 8, MOE_D, MOE_F, torch.bfloat16, MOE_D ** -0.5, dec)
    buf[3] = 0
    w[3, MOE_D // 3, MOE_F // 2] = float("nan")
    got, plain = launch("moe_gmm decode NaN", buf, w, True), moe_gmm_plain(buf, w)
    nan = plain.isnan()
    if int(nan.sum()) != 8 or not torch.equal(got.isnan(), nan):
        fail(f"moe_gmm decode: {int(got.isnan().sum())} NaNs where the plain version has "
             f"{int(nan.sum())} (expert 3's column {MOE_F // 2}: {int(nan[3].sum())})")
    worst = max(worst, compare("moe_gmm decode beside the NaN", got.masked_fill(nan, 0),
                               plain.masked_fill(nan, 0), TOL["bfloat16"]))
    print(f"moe_gmm decode: NaN on the {int(nan.sum())} elements where the plain version "
          f"has it (an expert of zero rows, one NaN in its w)")
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
    # mixtral-8x22b's widths (bf16, their own generator): one w a part for
    # every C; those of GMM_WIDE_TIMED timed with the rest
    wide = torch.Generator("cuda").manual_seed(WIDE_SEED)
    E, D, F = GMM_WIDE
    for part, (d_in, d_out) in (("gate_up", (D, F)), ("down", (F, D))):
        w = (d_in ** -0.5 * torch.randn(E, d_in, d_out, generator=wide, device="cuda")).bfloat16()
        for C, g in [(C, wide) for C in GMM_WIDE_C] + \
                [(C, dec) for C in GMM_DECODE_C if C not in GMM_WIDE_C]:
            buf = torch.randn(E, C, d_in, generator=g, device="cuda").bfloat16()
            err = check(f"moe_gmm mixtral {part} {(E, C, d_in, d_out)}", buf, w, TOL["bfloat16"])
            worst = max(worst, err)
            paths.update({f"{path}_{part}": (buf, w, err)
                          for path, c in GMM_WIDE_TIMED.items() if c == C})
        del w, buf
    got = ops.moe_gmm_variant_counts()
    n_wmma = len(GMM_WMMA_CASES) + len(GMM_DECODE_WMMA_CASES)
    if got != want or got["wmma"] != n_wmma:
        fail(f"moe_gmm launches by variant {got}, expected {want} with {n_wmma} on wmma")
    print(f"moe_gmm variants: {got}")
    timed = {}
    for name, (buf, w, err) in paths.items():
        E, C, D = buf.shape
        F = w.shape[2]
        # each of buf, w and out once; 2 operations per multiply-add
        b_ms, b_by = bound((E * C * D + E * D * F + E * C * F) * 2, 2.0 * E * C * D * F,
                           PEAK_BF16_FLOPS)
        variant = _variant(buf.dtype, C, D, F, True)
        timed[name] = {
            "shape": f"buf ({E}, {C}, {D}) x w ({E}, {D}, {F}) bf16", "variant": variant,
            "max_abs_err": err, "ms": device_ms(lambda: moe_gmm_cuda(buf, w)),
            "wrapper_ms": wrapper_ms(lambda: moe_gmm_cuda(buf, w)),
            "plain_ms": device_ms(lambda: moe_gmm_plain(buf, w)),
            "library_ms": device_ms(lambda: torch.bmm(buf, w)),
            "bound_ms": b_ms, "bound_by": b_by}
        if variant == "decode":   # and with w's bytes out of L2, as a round finds them
            timed[name].update({
                "cold_ms": device_ms(lambda: moe_gmm_cuda(buf, w), iters=10, cold=True),
                "library_cold_ms": device_ms(lambda: torch.bmm(buf, w), iters=10, cold=True)})
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
    f32 and bf16: GMM_BWD_C at qwen3-moe's widths and GMM_BWD_WIDE_C at
    mixtral-8x22b's (gate/up), D/F of no tile's width and a misaligned base
    (GMM_BWD_WMMA_CASES, bf16), the tc kernel's edges (GMM_BWD_EDGE), then
    each config's train microbatch, gate/up and down (C = 320 and 1280),
    also held per 64-row tile and timed warm and with L2 flushed (beside
    ``torch.bmm`` of the same product, likewise). Tolerance: TOL relative
    and TOL of the largest |value| (the products sum F or C terms in
    another order). Every bf16 call runs twice and must equal its repeat
    bit for bit. Every launch on the variant ``_bwd_variant`` names: bf16
    on ``tc`` but GMM_BWD_WMMA_CASES, on ``wmma``."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.moe_gmm import (
        _bwd_plan, _bwd_variant, moe_gmm_bwd_plain, moe_gmm_dw_cuda, moe_gmm_dx_cuda)
    from repro_torch.launch.kernel_times import (
        MOE_D, MOE_E, MOE_F, MOE_TRAIN_C, device_ms, wrapper_ms)
    worst = {"moe_gmm_dx": 0.0, "moe_gmm_dw": 0.0}
    want = {name: {"tc": 0, "wmma": 0, "fma": 0} for name in worst}

    def check(name, buf, w, dy, tma=True, tiles=None):
        """dX reads dy and w, dW buf and dy: each product's variant goes by
        its own operands' bases (a misaligned w leaves dW on ``tc``). A bf16
        product runs twice: the kernels sum each output in one block in a
        fixed order, so the repeat must be equal bit for bit."""
        dt = str(buf.dtype)[6:]
        calls = 2 if buf.dtype == torch.bfloat16 else 1
        for kern, operands in (("moe_gmm_dx", (dy, w)), ("moe_gmm_dw", (buf, dy))):
            variant = _bwd_variant(buf.dtype, buf.shape[2], w.shape[2],
                                   all(t.data_ptr() % 16 == 0 for t in operands))
            if buf.dtype == torch.bfloat16 and tma and variant != "tc":
                fail(f"{name}: bf16 {kern} would take {variant}")
            want[kern][variant] += calls
        got = (moe_gmm_dx_cuda(dy, w), moe_gmm_dw_cuda(buf, dy))
        if calls == 2:
            again = (moe_gmm_dx_cuda(dy, w), moe_gmm_dw_cuda(buf, dy))
            for kern, g, a in zip(worst, got, again):
                if not torch.equal(g, a):
                    fail(f"{name} {kern}: a repeated bf16 call differs from the first")
        for kern, g, p in zip(worst, got, moe_gmm_bwd_plain(buf, w, dy)):
            tol = TOL[dt] * float(p.float().abs().max())
            worst[kern] = max(worst[kern], compare(f"{name} {kern}", g, p, tol, TOL[dt]))
            if tiles is not None:
                tiles[kern] = compare_tiles(f"{name} {kern}", g[None], p[None])

    def randn(*shape, std=1.0, g=gen):
        return std * torch.randn(shape, generator=g, device="cuda")

    ops.reset_launch_counts()
    for C in GMM_BWD_C:
        for dt in (torch.float32, torch.bfloat16):
            check(f"moe_gmm bwd C={C} {dt}", randn(MOE_E, C, MOE_D).to(dt),
                  randn(MOE_E, MOE_D, MOE_F, std=MOE_D ** -0.5).to(dt),
                  randn(MOE_E, C, MOE_F).to(dt))
    # mixtral-8x22b's widths (gate/up), from their own generator
    wide = torch.Generator("cuda").manual_seed(WIDE_SEED)
    E, D, F = GMM_WIDE
    for C in GMM_BWD_WIDE_C:
        for dt in (torch.float32, torch.bfloat16):
            check(f"moe_gmm bwd mixtral C={C} {dt}", randn(E, C, D, g=wide).to(dt),
                  randn(E, D, F, std=D ** -0.5, g=wide).to(dt), randn(E, C, F, g=wide).to(dt))
    for (E, C, D, F, x_off, w_off) in GMM_BWD_WMMA_CASES:
        buf = randn(x_off + E * C * D).bfloat16()[x_off:].view(E, C, D)
        dy = randn(x_off + E * C * F).bfloat16()[x_off:].view(E, C, F)
        w = randn(w_off + E * D * F, std=D ** -0.5).bfloat16()[w_off:].view(E, D, F)
        check(f"moe_gmm bwd wmma {(E, C, D, F)} offsets {(x_off, w_off)}", buf, w, dy,
              tma=False)
    edge = torch.Generator("cuda").manual_seed(EDGE_SEED)
    for (E, C, D, F) in GMM_BWD_EDGE:
        for dt in (torch.float32, torch.bfloat16):
            check(f"moe_gmm bwd edge {(E, C, D, F)} {dt}", randn(E, C, D, g=edge).to(dt),
                  randn(E, D, F, std=D ** -0.5, g=edge).to(dt), randn(E, C, F, g=edge).to(dt))
    inputs, tile_rel = {}, {}
    # the train microbatch's (C = round(4096·K/E·1.25)): qwen3-moe-30b-a3b's
    # from the shared generator, then mixtral-8x22b's from its own
    wE, wD, wF = GMM_WIDE
    for part, (E, C, D, F, g) in (
            ("train_gate_up", (MOE_E, MOE_TRAIN_C, MOE_D, MOE_F, gen)),
            ("train_down", (MOE_E, MOE_TRAIN_C, MOE_F, MOE_D, gen)),
            ("mixtral_train_gate_up", (wE, GMM_BWD_WIDE_C[-1], wD, wF, wide)),
            ("mixtral_train_down", (wE, GMM_BWD_WIDE_C[-1], wF, wD, wide))):
        inputs[part] = (randn(E, C, D, g=g).bfloat16(),
                        randn(E, D, F, std=D ** -0.5, g=g).bfloat16(), randn(E, C, F, g=g).bfloat16())
        tile_rel[part] = {}
        check(f"moe_gmm bwd {part}", *inputs[part], tiles=tile_rel[part])
    got = ops.moe_gmm_bwd_variant_counts()
    # every GMM_BWD_WMMA_CASES case puts dX on wmma; dW all but the one
    # whose only misaligned operand is w; each bf16 product twice
    if got != want or (want["moe_gmm_dx"]["wmma"], want["moe_gmm_dw"]["wmma"]) != \
            (2 * len(GMM_BWD_WMMA_CASES), 2 * (len(GMM_BWD_WMMA_CASES) - 1)):
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
                "ms_l2_flushed": device_ms(call, iters=10, cold=True),
                "wrapper_ms": wrapper_ms(call), "plain_ms": plain_ms,
                "plain_covers": "dX and dW together", "library_ms": device_ms(library),
                "library_ms_l2_flushed": device_ms(library, iters=10, cold=True),
                "library": "torch.bmm", "bound_ms": b_ms, "bound_by": b_by,
                "n_fast": _bwd_plan(C, D, F, int(name == "moe_gmm_dw"))}
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
    # expert GEMMs per MoE layer (a VLM's layers are dense ones)
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


def _serving_model(cfg):
    """``cfg`` built on the card at full width, random weights from seed 0;
    the peak memory counter reset first."""
    import torch
    from repro_torch.models import build_model
    model = build_model(cfg, "cuda")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    print(f"model: {cfg.name} full width, {cfg.n_layers} layers, "
          f"{model.n_params() / 1e6:.1f}M params, {cfg.param_dtype}; init "
          f"{time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 1e9:.3f} GB allocated")
    return model, params


def prefill_replay(model, params, tokens, patches, fed, shift=0):
    """Decode from a prefill's cache, teacher-forced: the prefill of
    ``tokens`` (B, S), after a VLM's ``patches`` (None for a text model),
    then ``fed`` (B, R) by decode steps at positions n_patches + S + r +
    ``shift`` → their logits (R, B, V). ``shift`` 1 plants a fault in the
    cache offset: each step writes and reads one slot past its position,
    the slot skipped stays empty, and RoPE turns one position too far."""
    import torch
    B, S = tokens.shape
    R = fed.shape[1]
    n = 0 if patches is None else model.cfg.vision.n_patches
    extra = None if patches is None else {"patches": patches}
    _, cache = model.prefill(params, tokens, n + S + R + shift, extra)
    logits = []
    for r in range(R):
        out, cache = model.decode_step(params, cache, fed[:, r], n + S + r + shift)
        logits.append(out)
    return torch.stack(logits)


def prefill_forward(model, params, tokens, patches, fed):
    """The teacher-forced forward over ``patches`` (if any), ``tokens`` and
    ``fed``: its logits at text positions S .. S + R - 1 (R, B, V), those
    that ``prefill_replay``'s decode steps give."""
    import torch
    S, R = tokens.shape[1], fed.shape[1]
    batch = {"tokens": torch.cat([tokens, fed], dim=1)}
    if patches is not None:
        batch["patches"] = patches
    forward, _ = model.logits(params, batch, remat="none")
    return forward[:, S:S + R].transpose(0, 1)


def audio_replay(model, params, frames, fed, shift=0):
    """An audio model's decode, teacher-forced: ``fed`` (B, R) by decode
    steps at positions r + ``shift`` from ``encdec_serve_cache`` → their
    logits (R, B, V). ``shift`` 1 plants a fault in the per-row positions:
    each step takes the sinusoid of the next position and writes and reads
    one slot too far, the slot skipped left empty."""
    import torch
    from repro_torch.runtime.serve import encdec_serve_cache
    R = fed.shape[1]
    cache = encdec_serve_cache(model, params, frames, R + shift)
    logits = []
    for r in range(R):
        out, cache = model.decode_step(params, cache, fed[:, r], r + shift)
        logits.append(out)
    return torch.stack(logits)


def audio_forward(model, params, frames, fed):
    """The teacher-forced forward over ``fed`` and the same frames (R, B, V)."""
    forward, _ = model.logits(params, {"tokens": fed, "frames": frames}, remat="none")
    return forward.transpose(0, 1)


def decode_guard(name, model, params, decode_logits, replay, forward):
    """The main path's decode logits (bf16) against the teacher-forced
    forward over the same tokens. ``replay(model, params, shift)`` feeds
    those tokens again by decode steps, ``shift`` positions too far (0:
    none), and ``forward(model, params)`` runs the forward. In f32 (the
    same weights cast up) decode and forward differ only by rounding:
    within DECODE_F32_TOL of the largest logit. A replay with a planted
    fault (``shift`` 1) must lie beyond that limit, or the guard could not
    see a cache offset or position off by one. In bf16 both round through
    every layer, each its own way: the main path's decode must be no
    farther from the f32 forward than DECODE_BF16_RATIO times the bf16
    forward is, and the planted replay in bf16 farther than that."""
    import gc
    import torch
    from repro_torch.models import build_model

    def cast(t):
        return {k: cast(v) for k, v in t.items()} if isinstance(t, dict) else t.float()

    def rel(a, b):
        return float((a.float() - b.float()).abs().max() / b.float().abs().max())

    fwd16 = forward(model, params)
    m32, p32 = build_model(model.cfg.scaled(param_dtype="float32"), "cuda"), cast(params)
    fwd32 = forward(m32, p32)
    out = {"f32_decode_vs_forward": rel(replay(m32, p32, 0), fwd32),
           "f32_planted_vs_forward": rel(replay(m32, p32, 1), fwd32),
           "bf16_decode_vs_forward": rel(decode_logits, fwd16),
           "bf16_decode_vs_f32_forward": rel(decode_logits, fwd32),
           "bf16_forward_vs_f32_forward": rel(fwd16, fwd32),
           "bf16_planted_vs_f32_forward": rel(replay(model, params, 1), fwd32)}
    del m32, p32, fwd32, fwd16
    gc.collect()
    torch.cuda.empty_cache()
    print(f"decode guard {name} ({decode_logits.shape[0]} steps, relative to the largest "
          f"logit; planted: every step one position too far): {json.dumps(out)}")
    if not out["f32_decode_vs_forward"] <= DECODE_F32_TOL:
        fail(f"decode guard {name}: f32 decode is {out['f32_decode_vs_forward']:.3g} from "
             f"the teacher-forced forward (tol {DECODE_F32_TOL})")
    if not out["f32_planted_vs_forward"] > DECODE_F32_TOL:
        fail(f"decode guard {name}: a decode one position off is only "
             f"{out['f32_planted_vs_forward']:.3g} from the forward: within the guard's "
             f"tol {DECODE_F32_TOL}")
    limit = DECODE_BF16_RATIO * out["bf16_forward_vs_f32_forward"]
    if not out["bf16_decode_vs_f32_forward"] <= limit:
        fail(f"decode guard {name}: bf16 decode is {out['bf16_decode_vs_f32_forward']:.3g} "
             f"from the f32 forward, above {DECODE_BF16_RATIO} x the bf16 forward's "
             f"{out['bf16_forward_vs_f32_forward']:.3g}")
    if not out["bf16_planted_vs_f32_forward"] > limit:
        fail(f"decode guard {name}: a bf16 decode one position off is only "
             f"{out['bf16_planted_vs_f32_forward']:.3g} from the f32 forward: within the "
             f"guard's limit {limit:.3g}")
    return out


def serve_phase(config="qwen1.5-0.5b", layers=None):
    """``config`` served on the card at full width (``layers`` of its layers,
    or all): the prefill step, a VLM's or a DECODE_GUARDED config's decode
    rounds from its cache, the burst; launches, variants, the guards; for
    LONG_CONFIG then ``long_admission``. → (the main path's launches, per
    prefill, per decode round)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import synthetic_extras
    from repro_torch.kernels import ops
    from repro_torch.launch import serve_workload
    from repro_torch.models.layers import tree_leaves
    from repro_torch.runtime.serve import greedy_decode, make_prefill_step

    cfg = get_config(config)
    if layers is not None:
        cfg = cfg.scaled(n_layers=layers)
    model, params = _serving_model(cfg)
    B, S = 4, 1024
    # a VLM's prefill step: 576 patch rows (f32 from synthetic_extras, cast
    # by the model) before the 1024 tokens, in a cache with room for
    # VLM_ROUNDS decode rounds after them (a DECODE_GUARDED config's: the
    # tokens alone, then as many rounds)
    rounds_after = VLM_ROUNDS if cfg.family == "vlm" or config in DECODE_GUARDED else 0
    n_patches = cfg.vision.n_patches if cfg.family == "vlm" else 0
    step, _, _ = make_prefill_step(model, ShapeConfig("prefill_1k", S + rounds_after, B, "prefill"))
    tokens = torch.randint(2, cfg.vocab, (B, S), device="cuda",
                           generator=torch.Generator("cuda").manual_seed(1))
    args = {"params": params, "tokens": tokens}
    if cfg.family == "vlm":
        args["patches"] = torch.from_numpy(synthetic_extras(
            "vlm", B, cfg, np.random.default_rng(1))["patches"]).cuda()

    # ---- the main path: counts from 0, read right after ----
    ops.reset_launch_counts()
    step(args)                                                 # warm-up
    torch.cuda.synchronize()
    per_prefill = ops.launch_counts()
    t0 = time.perf_counter()
    nxt, cache = step(args)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    if rounds_after:
        t0 = time.perf_counter()
        guard_logits, guard_fed = greedy_decode(model, params, cache, nxt[:, None],
                                                n_patches + S, rounds_after)
        torch.cuda.synchronize()
        rounds_s = time.perf_counter() - t0
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
    # prefill steps, one prefill per admission, then the engine's rounds (and
    # a VLM's rounds from its prefill's cache)
    prefills, rounds = 2 + batcher.prefills, batcher.steps + rounds_after
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
    print(f"prefill step B={B} S={S}"
          f"{f' after {n_patches} patch rows' if n_patches else ''}: {prefill_ms:.3f} ms")
    if rounds_after:
        print(f"{rounds_after} greedy decode rounds from the prefill's cache (B={B}, from "
              f"position {n_patches + S}): {rounds_s:.3f} s, "
              f"{B * rounds_after / rounds_s:.1f} tokens/s")
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
    if rounds_after:
        patches = args.get("patches")
        decode_guard(f"{cfg.name} decode from the prefill's cache", model, params, guard_logits,
                     lambda m, p, shift: prefill_replay(m, p, tokens, patches, guard_fed, shift),
                     lambda m, p: prefill_forward(m, p, tokens, patches, guard_fed))

    print(f"launches: main path {launches} over {prefills} prefills and {rounds} "
          f"decode rounds; per prefill {per_prefill}, per decode round {per_round}")
    launches["flash_fwd_variants"] = variants
    launches["moe_gmm_variants"] = gmm_variants
    launches["ssd_scan_variants"] = ssd_variants
    if config == LONG_CONFIG:
        del served, batcher, cache
        launches["long_admission"] = long_admission(model, params)
    return launches, per_prefill, per_round


def long_admission(model, params):
    """LONG_CONFIG's long admission (phase 12): ``Model.prefill`` of
    LONG_PROMPT tokens into a cache of LONG_MAX_LEN slots, so that each
    layer's ring holds its window of 4096 slots: the prefill's attention
    runs with the window cutting every row past 4096, its grouped GEMM at C
    = 1920, and the cache keeps the last 4096 positions through
    ``_to_cache_slots``' roll; then LONG_ROUNDS greedy rounds, each written
    at pos % 4096. Launches: one prefill and LONG_ROUNDS equal rounds of
    ``expected_launches``, the prefill's on ``tc_prefill``, the rounds' on
    ``split_decode`` and the gmm's ``decode``. The logits must be finite,
    and layer 0's K ring after the prefill must equal K recomputed from the
    normed embeddings (``_roped_qkv``) at each kept position's slot pos %
    4096, within RING_TOL of the largest value, where the same ring rolled
    one slot must not. → the path's launches and readings."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch.kernel_times import device_ms
    from repro_torch.models.transformer import _roped_qkv, embed_inputs, unstack
    from repro_torch.runtime.serve import greedy_decode

    cfg = model.cfg
    tokens = torch.randint(2, cfg.vocab, (1, LONG_PROMPT), device="cuda",
                           generator=torch.Generator("cuda").manual_seed(4))

    # ---- the main path: counts from 0, read right after ----
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, tokens, LONG_MAX_LEN)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    per_prefill = ops.launch_counts()
    ring = cache["window"]["k"][0, 0, 0].clone()           # layer 0 after the prefill
    t0 = time.perf_counter()
    rounds, _ = greedy_decode(model, params, cache, logits.argmax(-1)[:, None], LONG_PROMPT,
                              LONG_ROUNDS)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    variants = {"flash_fwd": ops.flash_variant_counts(), "moe_gmm": ops.moe_gmm_variant_counts()}
    # ---- end of the main path ----

    if not (bool(torch.isfinite(logits).all()) and bool(torch.isfinite(rounds).all())):
        fail(f"{cfg.name} long admission: non-finite logits")
    want_prefill, want_round = expected_launches(cfg)
    launches = {k: n for k, n in launches.items() if n}
    per_prefill = {k: n for k, n in per_prefill.items() if n}
    per_round = {k: (n - per_prefill.get(k, 0)) // LONG_ROUNDS for k, n in launches.items()}
    if per_prefill != want_prefill or per_round != want_round or \
            any((n - per_prefill.get(k, 0)) % LONG_ROUNDS for k, n in launches.items()):
        fail(f"{cfg.name} long admission: launches {launches}, {per_prefill} in the prefill; "
             f"expected {want_prefill} and {LONG_ROUNDS} rounds of {want_round}")
    want_variants = {
        "flash_fwd": {"tc_prefill": want_prefill["flash_fwd"],
                      "split_decode": LONG_ROUNDS * want_round["flash_fwd"], "fma": 0},
        "moe_gmm": {"tc_prefill": want_prefill["moe_gmm"],
                    "decode": LONG_ROUNDS * want_round["moe_gmm"], "wmma": 0, "fma": 0}}
    if variants != want_variants:
        fail(f"{cfg.name} long admission: variants {variants}, expected {want_variants}")

    # layer 0's K over the prompt, recomputed; the ring keeps its last
    # ``slots`` positions, each at pos % slots
    p0 = unstack(params["blocks"])[0][0]
    h = ops.rmsnorm(embed_inputs(cfg, params, tokens), p0["ln1"], cfg.norm_eps)
    _, k, _ = _roped_qkv(cfg, p0["attn"], h, torch.arange(LONG_PROMPT, device="cuda")[None])
    slots = ring.shape[0]
    kept = torch.arange(LONG_PROMPT - slots, LONG_PROMPT, device="cuda")
    want = torch.zeros_like(ring)
    want[kept % slots] = k[0, kept]
    tol = RING_TOL * float(want.float().abs().max())
    err = compare(f"{cfg.name} long admission: layer 0's K ring", ring, want, tol, 0.0)
    planted = float((torch.roll(ring, 1, dims=0).float() - want.float()).abs().max())
    # the same path again, for its device time (the profiler slows the host)
    busy = {"prefill_ms": device_ms(lambda: model.prefill(params, tokens, LONG_MAX_LEN),
                                    iters=1, warmup=0),
            "rounds_ms": device_ms(lambda: greedy_decode(
                model, params, cache, logits.argmax(-1)[:, None], LONG_PROMPT, LONG_ROUNDS),
                iters=1, warmup=0)}
    busy["idle_share"] = 1 - (busy["prefill_ms"] + busy["rounds_ms"]) / (prefill_ms
                                                                        + decode_s * 1e3)
    print(f"{cfg.name} long admission ({LONG_PROMPT} tokens, {slots}-slot rings, "
          f"{LONG_MAX_LEN}-slot cache): prefill {prefill_ms:.3f} ms; {LONG_ROUNDS} rounds "
          f"{decode_s:.3f} s, {LONG_ROUNDS / decode_s:.2f} tokens/s; device busy "
          f"{json.dumps(busy)}; peak memory {torch.cuda.max_memory_allocated() / 1e9:.3f} GB; "
          f"layer 0's K ring max abs err {err:.3g}, rolled one slot {planted:.3g} (tol "
          f"{tol:.3g}); launches {launches}, per prefill {per_prefill}, variants {variants}")
    if not planted > tol:
        fail(f"{cfg.name} long admission: a ring rolled one slot is only {planted:.3g} "
             f"from the recomputed K rows: within the check's tol {tol:.3g}")
    return {"launches": launches, "per_prefill": want_prefill, "per_round": want_round,
            "by_variant": variants, "prefill_ms": prefill_ms, "round_s": decode_s / LONG_ROUNDS,
            "busy": busy, "ring_max_abs_err": err, "ring_rolled_one_slot_err": planted}


def ring_guard_phase():
    """Phase 12's ring guard: gemma3-12b cut to RING_LAYERS of its 48
    layers at full width (two 5:1 groups, 4.70 B parameters: the guard's
    f32 copy takes 18.8 GB beside the 9.4 GB of bf16 weights, where all 48
    layers' would take 51 GB and do not fit), through a one-slot
    ``ContinuousBatcher`` of RING_MAX_LEN slots: one request of RING_PROMPT
    tokens, whose admission overfills the local layers' 1024-slot rings,
    then RING_ROUNDS decode rounds, which wrap them. Launches: one prefill
    and RING_ROUNDS equal rounds of ``expected_launches``, on
    ``tc_prefill`` and ``split_decode``. Then the decode guard over the
    rounds' logits, as phase 10's. → the path's launches."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.kernel_times import device_ms
    from repro_torch.runtime.serve import ContinuousBatcher, Request

    cfg = get_config(GEMMA3_CONFIG).scaled(n_layers=RING_LAYERS)
    model, params = _serving_model(cfg)
    prompt = torch.randint(2, cfg.vocab, (RING_PROMPT,), device="cuda",
                           generator=torch.Generator("cuda").manual_seed(5)).tolist()
    batcher = ContinuousBatcher(model, params, batch_slots=1, max_len=RING_MAX_LEN,
                                eos_token=-1)                  # every round runs
    req = Request("ring", prompt, max_new_tokens=RING_ROUNDS)
    rounds = []
    decode = model.decode_step

    def recording(*args):   # each round's logits, for the guard
        out, cache = decode(*args)
        rounds.append(out)
        return out, cache

    # ---- the main path: counts from 0, read right after ----
    ops.reset_launch_counts()
    model.decode_step = recording
    try:
        t0 = time.perf_counter()
        batcher.submit(req)
        batcher.drain()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        del model.decode_step
    launches = ops.launch_counts()
    variants = ops.flash_variant_counts()
    # ---- end of the main path ----

    logits = torch.stack(rounds)                               # (R, 1, V)
    if (batcher.prefills, batcher.steps, len(req.tokens_out)) != (1, RING_ROUNDS, RING_ROUNDS) \
            or not batcher.all_logits_finite():
        fail(f"{cfg.name} ring: {batcher.prefills} prefills, {batcher.steps} rounds, "
             f"{len(req.tokens_out)} tokens, finite {batcher.all_logits_finite()}")
    want_prefill, want_round = expected_launches(cfg)
    want = {k: want_prefill[k] + RING_ROUNDS * want_round[k] for k in want_prefill}
    if {k: n for k, n in launches.items() if n} != want:
        fail(f"{cfg.name} ring: launches {launches}, expected {want}")
    want_variants = {"tc_prefill": want_prefill["flash_fwd"],
                     "split_decode": RING_ROUNDS * want_round["flash_fwd"], "fma": 0}
    if variants != want_variants:
        fail(f"{cfg.name} ring: flash variants {variants}, expected {want_variants}")

    def again():   # the same path, for its device time (the profiler slows the host)
        b = ContinuousBatcher(model, params, batch_slots=1, max_len=RING_MAX_LEN, eos_token=-1)
        b.submit(Request("ring", prompt, max_new_tokens=RING_ROUNDS))
        b.drain()

    busy_ms = device_ms(again, iters=1, warmup=0)
    print(f"{cfg.name} ring ({RING_LAYERS} layers): a {RING_PROMPT}-token prompt and "
          f"{RING_ROUNDS} rounds through a one-slot batcher in {seconds:.3f} s, "
          f"{RING_ROUNDS / seconds:.2f} tokens/s; device busy {busy_ms:.3f} ms, idle "
          f"{1 - busy_ms / (seconds * 1e3):.4f}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB; launches "
          f"{launches}, variants {variants}")
    tokens = torch.tensor([prompt[:-1]], device="cuda")
    fed = torch.tensor([[prompt[-1]] + req.tokens_out[:-1]], device="cuda")
    out = decode_guard(f"{cfg.name} ({RING_LAYERS} layers) ring decode through the batcher",
                       model, params, logits,
                       lambda m, p, shift: prefill_replay(m, p, tokens, None, fed, shift),
                       lambda m, p: prefill_forward(m, p, tokens, None, fed))
    return {"launches": launches, "per_prefill": want_prefill, "per_round": want_round,
            "by_variant": variants, "seconds": seconds, "busy_ms": busy_ms,
            "decode_guard": out}


def expected_audio_launches(cfg):
    """An audio model's launches per prefill step (the forward over the
    frames and the tokens), per cache fill (the encoder) and per decode
    round: attention once a layer in the encoder, self and cross in the
    decoder; two norms a layer in the encoder and its final one, three a
    decoder layer and the final one."""
    Le, L = cfg.encdec.n_encoder_layers, cfg.n_layers
    fill = {"flash_fwd": Le, "rmsnorm": 2 * Le + 1}
    rnd = {"flash_fwd": 2 * L, "rmsnorm": 3 * L + 1}
    return {k: fill[k] + rnd[k] for k in fill}, fill, rnd


def audio_serve_phase(config=AUDIO_CONFIG):
    """Full-width, full-depth whisper-tiny on the card, on the path
    ``profile_serve`` profiles (its AUDIO_* sizes): the prefill step (the
    forward over AUDIO_PREFILL tokens and 1500 frames) twice, then
    AUDIO_CLIPS clips of 1500 frames (``synthetic_extras``, cast to bf16):
    ``encdec_serve_cache`` (the encoder and every layer's cross K/V), the
    AUDIO_PROMPT-token prompts fed by decode steps, greedy rounds up to
    AUDIO_MAX_LEN positions. Launches split into two prefills, one cache
    fill and AUDIO_MAX_LEN equal decode rounds, each of the counts
    ``expected_audio_launches`` gives: every prefill and fill launch on
    ``tc_prefill``, every round's on ``split_decode`` (the cross-attention's
    with no kv_len). Then the decode guard against the teacher-forced
    forward over the fed tokens."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import synthetic_extras
    from repro_torch.kernels import ops
    from repro_torch.launch.profile_serve import (
        AUDIO_CLIPS, AUDIO_MAX_LEN, AUDIO_PREFILL, AUDIO_PROMPT)
    from repro_torch.runtime.serve import encdec_serve_cache, greedy_decode, make_prefill_step

    cfg = get_config(config)
    model, params = _serving_model(cfg)
    frames = torch.from_numpy(synthetic_extras(
        "audio", AUDIO_CLIPS, cfg, np.random.default_rng(1))["frames"]).cuda().bfloat16()
    gen = torch.Generator("cuda").manual_seed(1)
    pb, ps = AUDIO_PREFILL
    step, _, _ = make_prefill_step(model, ShapeConfig("prefill_448", ps, pb, "prefill"))
    args = {"params": params, "frames": frames[:pb],
            "tokens": torch.randint(2, cfg.vocab, (pb, ps), device="cuda", generator=gen)}
    prompt = torch.randint(2, cfg.vocab, (AUDIO_CLIPS, AUDIO_PROMPT), device="cuda",
                           generator=gen)

    # ---- the main path: counts from 0, read right after ----
    ops.reset_launch_counts()
    step(args)                                                 # warm-up
    torch.cuda.synchronize()
    per_prefill = ops.launch_counts()
    t0 = time.perf_counter()
    nxt, _ = step(args)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    before = ops.launch_counts()
    t0 = time.perf_counter()
    cache = encdec_serve_cache(model, params, frames, AUDIO_MAX_LEN)
    torch.cuda.synchronize()
    fill_ms = (time.perf_counter() - t0) * 1e3
    per_fill = {k: n - before[k] for k, n in ops.launch_counts().items()}
    t0 = time.perf_counter()
    logits, fed = greedy_decode(model, params, cache, prompt, 0, AUDIO_MAX_LEN)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    variants = ops.flash_variant_counts()
    # ---- end of the main path ----

    if nxt.shape != (pb,) or not bool(torch.isfinite(logits).all()):
        fail(f"{cfg.name}: wrong prefill shape or non-finite decode logits")
    want_prefill, want_fill, want_round = expected_audio_launches(cfg)
    per_round = {}
    for name, n in launches.items():
        rest = n - 2 * per_prefill[name] - per_fill[name]
        if name not in want_round:
            if n:
                fail(f"kernel {name} launched while serving {cfg.name}")
            continue
        if rest < 0 or rest % AUDIO_MAX_LEN:
            fail(f"kernel {name}: {n} launches do not split into 2 prefills of "
                 f"{per_prefill[name]}, a cache fill of {per_fill[name]} and "
                 f"{AUDIO_MAX_LEN} equal decode rounds")
        per_round[name] = rest // AUDIO_MAX_LEN
    got = tuple({k: d[k] for k in want_round} for d in (per_prefill, per_fill, per_round))
    if got != (want_prefill, want_fill, want_round):
        fail(f"{cfg.name}: launches per prefill, cache fill and decode round {got}, "
             f"expected {(want_prefill, want_fill, want_round)}")
    want_variants = {"tc_prefill": 2 * want_prefill["flash_fwd"] + want_fill["flash_fwd"],
                     "split_decode": want_round["flash_fwd"] * AUDIO_MAX_LEN, "fma": 0}
    if variants != want_variants:
        fail(f"{cfg.name}: flash variants {variants}, expected {want_variants}")
    print(f"flash variants: {variants}")
    tokens = AUDIO_CLIPS * AUDIO_MAX_LEN
    print(f"{cfg.name}: prefill step B={pb} S={ps} with {cfg.encdec.n_frames} frames "
          f"{prefill_ms:.3f} ms; cache fill ({AUDIO_CLIPS} clips: encoder and cross K/V) "
          f"{fill_ms:.3f} ms; {AUDIO_MAX_LEN} decode steps ({AUDIO_PROMPT} prompt tokens, "
          f"then greedy) {decode_s:.3f} s, {tokens / decode_s:.1f} tokens/s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    decode_guard(f"{cfg.name} decode from encdec_serve_cache", model, params, logits,
                 lambda m, p, shift: audio_replay(m, p, frames, fed, shift),
                 lambda m, p: audio_forward(m, p, frames, fed))
    print(f"launches: main path {launches}; per prefill {got[0]}, per cache fill {got[1]}, "
          f"per decode round {got[2]}")
    launches = {k: launches[k] for k in want_round}
    launches["flash_fwd_variants"] = variants
    return launches, {"prefill": got[0], "cache_fill": got[1]}, got[2]


def flash_bwd_phase(gen):
    """The backward kernels against the plain version: FLASH_BWD_CASES in f32
    (the FMA kernels) and bf16 (the tensor-core kernels), the launches by
    variant checked; then the BWD_PATHS shapes (bf16, O and lse from the
    forward kernel), each also held per 64-row tile and timed."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import (
        _delta, _mask, flash_attention_bwd_cuda, flash_attention_bwd_plain,
        flash_attention_cuda, flash_bwd_dkv_cuda, flash_bwd_dq_cuda)
    from repro_torch.launch.kernel_times import device_ms, wrapper_ms
    worst = {"flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0}   # each kernel's own outputs
    tile_rel = {}

    def randn(*shape, g=gen):
        return torch.randn(shape, generator=g, device="cuda")

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
    wide = torch.Generator("cuda").manual_seed(WIDE_SEED)
    cases = [(gen, case) for case in FLASH_BWD_CASES] + \
        [(wide, case) for case in FLASH_BWD_WIDE_CASES]
    for g, (S, T, Hq, Hkv, D, causal, window) in cases:
        for dt in (torch.float32, torch.bfloat16):
            q, do = randn(2, S, Hq, D, g=g).to(dt), randn(2, S, Hq, D, g=g).to(dt)
            k, v = randn(2, T, Hkv, D, g=g).to(dt), randn(2, T, Hkv, D, g=g).to(dt)
            check(f"flash bwd {(S, T, Hq, Hkv, D, causal, window)} {dt}",
                  q, k, v, do, causal, window, TOL[str(dt)[6:]])
    n = len(cases)
    want = {name: {"tc": n, "fma": n} for name in worst}
    if ops.flash_bwd_variant_counts() != want:
        fail(f"flash bwd variants {ops.flash_bwd_variant_counts()}, expected {want} "
             f"(the tensor-core kernels for bf16, FMA for f32)")
    print(f"flash bwd: checked cases by variant {want}")

    timed = {name: {} for name in worst}
    for path, (B, S, T, Hq, Hkv, D, causal, window) in BWD_PATHS.items():
        g = wide if path in BWD_WIDE_PATHS else gen
        q, do = (randn(B, S, Hq, D, g=g).to(torch.bfloat16) for _ in range(2))
        k, v = (randn(B, T, Hkv, D, g=g).to(torch.bfloat16) for _ in range(2))
        tile_rel[path] = {}
        o, lse = check(f"flash bwd {path}", q, k, v, do, causal, window, TOL["bfloat16"],
                       tiles=tile_rel[path])
        delta = _delta(o, do).contiguous()
        pairs = B * Hq * (_causal_pairs(S, window) if causal else S * T)
        q_b, kv_b, stat_b = B * S * Hq * D * 2, B * T * Hkv * D * 2, B * Hq * S * 4
        plain_ms = device_ms(lambda: flash_attention_bwd_plain(
            q, k, v, o, lse, do, causal=causal, window=window), iters=5)
        # SDPA has no window: one narrower than S goes to it as a band mask
        # (gemma3's 1024 at S = 1024 leaves every causal key)
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
        gqa = {"enable_gqa": True} if Hq != Hkv else {}
        if window and window < S:
            out = F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=_mask(S, T, causal, window, "cuda"), **gqa)
        else:
            out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal, **gqa)
        dot = do.transpose(1, 2)
        library_ms = device_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                                           retain_graph=True))
        shape = (f"B={B} S={S} T={T} Hq={Hq} Hkv={Hkv} D={D} "
                 f"{'causal' if causal else 'non-causal'}"
                 f"{f' window {window}' if window else ''} bf16")
        calls = {
            # (call, bytes: inputs once + outputs once, operations per valid pair)
            "flash_bwd_dq": (lambda: flash_bwd_dq_cuda(q, k, v, do, lse, delta, causal=causal,
                                                       window=window),
                             3 * q_b + 2 * kv_b + 2 * stat_b, 3 * 2 * D),
            "flash_bwd_dkv": (lambda: flash_bwd_dkv_cuda(q, k, v, do, lse, delta,
                                                         causal=causal, window=window),
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
                                                               causal=causal, window=window))
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
    elif cfg.family == "audio":           # the encoder (1 attention, 2 norms a layer,
        Le = cfg.encdec.n_encoder_layers  # its final norm) is not recomputed; a
        each = {"flash_fwd": Le + 4 * L,  # decoder layer has 2 attentions, 3 norms
                "flash_bwd_dq": Le + 2 * L, "flash_bwd_dkv": Le + 2 * L,
                "rmsnorm": 2 * Le + 1 + 6 * L + 1}
    else:                                 # attention and 2 norms a layer
        each = {"flash_fwd": 2 * L, "flash_bwd_dq": L, "flash_bwd_dkv": L,
                "rmsnorm": 4 * L + 1}
        if cfg.family == "moe":           # and three expert GEMMs
            each.update(moe_gmm=6 * L, moe_gmm_dx=3 * L, moe_gmm_dw=3 * L)
    return {name: n_micro * n for name, n in each.items()}


# per family: the kernels the gradient guard puts on their plain versions
# (launch counter names), and the names their dispatch asks ``ops._on_cuda``
GUARD_SWAPS = {
    "moe": (("moe_gmm", "moe_gmm_dx", "moe_gmm_dw"), ("moe_gmm", "moe_gmm_bwd")),
    "ssm": (("ssd_scan", "ssd_scan_bwd"), ("ssd_scan", "ssd_scan_bwd")),
    "hybrid": (("ssd_scan", "ssd_scan_bwd"), ("ssd_scan", "ssd_scan_bwd")),
    **dict.fromkeys(("dense", "vlm", "audio"), (
        ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "rmsnorm"),
        ("flash_attention_fwd", "flash_attention_bwd", "rmsnorm"))),
}


def grad_guard(config):
    """One microbatch's loss gradients, every leaf, at ``config``'s train
    width and depth: through the kernels against the same with the family's
    own kernels (forward and backward) on their plain versions on the card
    (GUARD_SWAPS: the grouped GEMM's, the SSD scan's, or the flash
    attention's and RMSNorm's), measured as the norm of the difference over
    the norm of the plain f32 gradients. In f32 (the same weights cast up)
    the two differ only by the kernels' summation order: within
    GRAD_F32_TOL. In bf16 both sit some 10 % from the f32 result after 48
    Mamba layers (rounding through the layers, as the state guard's bf16
    logits): the kernels' must be no farther from it than the plain
    versions' plus GUARD_TOL."""
    import gc
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import profile_train
    from repro_torch.models import build_model
    from repro_torch.optim.adamw import tree_leaves, tree_map

    cfg, _ = profile_train.train_depth(config)
    shape, tcfg = profile_train.train_shape(config), profile_train.train_config(config)
    m16 = build_model(cfg, "cuda")
    p16 = m16.init(torch.Generator("cuda").manual_seed(0))
    m32 = build_model(cfg.scaled(param_dtype="float32"), "cuda")
    p32 = tree_map(lambda t: t.float(), p16)
    n_micro = shape.global_batch // tcfg.microbatch_per_device
    batch = profile_train.train_batch(cfg, shape, 0, "cuda")
    mb = {k: v[0::n_micro] for k, v in batch.items()}
    on_cuda = ops._on_cuda
    # the kernels the path swaps (their launch counters), and the names their
    # dispatch asks ``ops._on_cuda`` under
    swapped, dispatch = GUARD_SWAPS[cfg.family]

    def plain_on_card(t, name):
        return name not in dispatch and on_cuda(t, name)

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
    guard_rel = grad_guard(config) if config in TRAIN_CONFIGS else None
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, step, state, batch = profile_train.setup(seed=0, config=config)
    torch.cuda.synchronize()
    shape, tcfg = profile_train.train_shape(config), profile_train.train_config(config)
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
    # bf16 at S = 1024 or 2048 (C = 320 or 1280 tokens an expert): every
    # forward on the tensor-core prefill variants, every backward on its
    # tensor-core kernel; the others' variants launch nothing
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


# phase 14: the mesh path (qwen1.5-0.5b at profile_train's train shape, then
# the serving shapes of phase 4)
MESH_CONFIG = "qwen1.5-0.5b"
MESH_DECODE_STEPS = 16
ROOFLINE_MAX = 1.05           # measured device time under the analytic ideal fails


def _state_diff(got, want):
    """Leaves of two trees that differ: → {key: max |Δ|}, empty when every
    leaf is bit-identical (``got`` may hold DTensors)."""
    from repro_torch.checkpoint.ckpt import _leaves
    from repro_torch.runtime.sharding import unshard_tree
    w = dict(_leaves(want))
    out = {}
    for k, t in _leaves(unshard_tree(got)):
        if not torch_equal(t, w[k]):
            out["/".join(k)] = float((t.float() - w[k].float()).abs().max())
    return out


def torch_equal(a, b):
    import torch
    return a.shape == b.shape and a.dtype == b.dtype and bool(torch.equal(a, b))


def _cuda_ms(fn):
    import torch
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def mesh_phase(card):
    """Phase 14: the train and serve steps on the host mesh, a (1, 1)
    ``("data", "model")`` DeviceMesh over NCCL in a world of one, with
    DTensor state placed by ``repro``'s rules, held bit for bit against the
    same steps with ``mesh=None``; int8 compression of a full-width
    gradient tree; an elastic restore; the analytic roofline against the
    measured device time. → (the mesh train path's launches, per step)."""
    import shutil
    import tempfile
    import torch
    import torch.distributed as dist
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import ops
    from repro_torch.launch import analysis, kernel_times, profile_train
    from repro_torch.launch.mesh import make_host_mesh, make_mesh
    from repro_torch.models import build_model
    from repro_torch.models.layers import tree_leaves
    from repro_torch.optim import (AdamW, compressed_psum_pod, dequantize_int8,
                                   error_feedback_update, quantize_int8)
    from repro_torch.runtime.serve import make_prefill_step, make_serve_step
    from repro_torch.runtime.sharding import shard_tree, unshard_tree
    from repro_torch.runtime.train import init_state, make_train_step

    mesh = make_host_mesh()
    print(f"mesh: {mesh} over {dist.get_backend()}, world {dist.get_world_size()}")
    cfg, _ = profile_train.train_depth(MESH_CONFIG)
    model = build_model(cfg)
    tcfg, shape = profile_train.train_config(MESH_CONFIG), profile_train.train_shape(MESH_CONFIG)
    n_micro = shape.global_batch // tcfg.microbatch_per_device
    batch = profile_train.train_batch(cfg, shape, 0, "cuda")
    step_m, state_sh, batch_sh, specs = make_train_step(model, tcfg, shape, mesh)
    step_0, none_sh, _, _ = make_train_step(model, tcfg, shape)
    if none_sh is not None:
        fail("mesh: make_train_step(mesh=None) returned shardings")
    seed = lambda: torch.Generator("cuda").manual_seed(0)  # noqa: E731

    # step 1's accumulated gradients, for the compression checks
    grads = []
    update = AdamW.update

    def recording_update(self, g, state, params):
        if not grads:
            grads.append([t.to_local().clone() for t in tree_leaves(g)])
        return update(self, g, state, params)

    # ---- the main path: counts from 0, read right after ----
    state = shard_tree(init_state(model, tcfg, seed()), state_sh)
    batch_d = shard_tree(batch, batch_sh)
    AdamW.update = recording_update
    ops.reset_launch_counts()
    losses_m, ms_m, counts = [], [], []
    busy_ms = None
    try:
        for i in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            if i == 1:          # step 2 under the profiler: its device time
                acts = [torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                with torch.profiler.profile(activities=acts) as prof:
                    start.record()
                    state, m = step_m(state, batch_d)
                    end.record()
                    torch.cuda.synchronize()
                busy_ms = sum(e.time_range.elapsed_us() for e in prof.events()
                              if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
                if not busy_ms:   # the profiler recorded nothing: the step's span
                    busy_ms = start.elapsed_time(end)
                    kernel_times.event_timed_readings += 1
            else:
                state, m = step_m(state, batch_d)
                torch.cuda.synchronize()
            ms_m.append((time.perf_counter() - t0) * 1e3)
            losses_m.append(float(m["loss"]))
            counts.append(ops.launch_counts())
    finally:
        AdamW.update = update
    launches = ops.launch_counts()
    variants = {"flash_fwd": ops.flash_variant_counts(), **ops.flash_bwd_variant_counts()}
    # ---- end of the main path ----

    expected = expected_train_launches(cfg, n_micro)
    for name in [k for k in launches if k not in expected]:
        if launches.pop(name):
            fail(f"mesh train: {name} launched")
    per_step = {}
    for name, n in launches.items():
        steps = [counts[0][name]] + [counts[i][name] - counts[i - 1][name]
                                     for i in range(1, TRAIN_STEPS)]
        if len(set(steps)) != 1:
            fail(f"mesh train: {name} launches {steps} do not split into equal steps")
        per_step[name] = steps[0]
    if per_step != expected:
        fail(f"mesh train: launches per step {per_step}, phase 5's {expected}")
    on = {"flash_fwd": "tc_prefill", "flash_bwd_dq": "tc", "flash_bwd_dkv": "tc"}
    for name, by_variant in variants.items():
        want = {v: (launches[name] if v == on[name] else 0) for v in by_variant}
        if by_variant != want:
            fail(f"mesh train: {name} launches by variant {by_variant}, expected {want}")

    ref = init_state(model, tcfg, seed())
    losses_0, ms_0 = [], []
    for i in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        ref, m0 = step_0(ref, batch)
        torch.cuda.synchronize()
        ms_0.append((time.perf_counter() - t0) * 1e3)
        losses_0.append(float(m0["loss"]))
    diff = _state_diff(state, ref)
    bit = losses_m == losses_0 and not diff
    print(f"mesh train: {cfg.name} full width, {model.n_params() / 1e6:.1f}M params, "
          f"B={shape.global_batch} S={shape.seq_len}, {n_micro} microbatches; losses on the "
          f"mesh {losses_m}, with mesh=None {losses_0}; every loss and leaf bit-identical: "
          f"{bit}")
    if not bit:
        worst = max(diff.items(), key=lambda kv: kv[1]) if diff else None
        fail(f"mesh train: the mesh run differs from mesh=None: losses {losses_m} vs "
             f"{losses_0}, {len(diff)} leaves differ (largest {worst})")
    host_m, host_0 = ms_m[2:], ms_0[2:]
    print(f"mesh train host ms a step (synchronised; step 2 on the mesh profiled): mesh "
          f"{ms_m}, mesh=None {ms_0}; steps 3-4 mean {sum(host_m) / len(host_m):.3f} vs "
          f"{sum(host_0) / len(host_0):.3f} ms ({card})")
    print(f"launches: mesh train path {launches} over {TRAIN_STEPS} steps; per step "
          f"{per_step} (phase 5's {expected})")

    # ---- compression, on step 1's accumulated f32 gradient tree ----
    g1 = grads[0]
    (deq, res), ef_ms = _cuda_ms(lambda: error_feedback_update(
        g1, [torch.zeros_like(t) for t in g1]))
    for k, (g, d, r) in enumerate(zip(g1, deq, res)):
        scale = float(g.abs().max()) / 127.0 + 1e-12
        ulp = math.ulp(scale)
        err = float((d + r - g).abs().max())
        if err > ulp:
            fail(f"compression: leaf {k}: deq + residual is {err} from g, over one ulp "
                 f"({ulp}) of its scale")
    pod_mesh = make_mesh((1, 1, 1), ("pod", "data", "model"))
    summed, psum_ms = _cuda_ms(lambda: compressed_psum_pod(g1, pod_mesh))
    for k, (g, got) in enumerate(zip(g1, summed)):
        if not torch.equal(got, dequantize_int8(*quantize_int8(g))):
            fail(f"compression: leaf {k}: the 1-rank pod sum is not dequantize(quantize(g))")
    n_el = sum(t.numel() for t in g1)
    print(f"compression: {len(g1)} leaves, {n_el} f32 gradients of step 1: error feedback "
          f"{ef_ms:.3f} ms, 1-rank pod all-reduce {psum_ms:.3f} ms (CUDA events; {card})")
    del grads, g1, deq, res, summed

    # ---- elastic restore: the mesh state after step 4, saved and restored ----
    scratch = ROOT / "build"
    scratch.mkdir(exist_ok=True)
    ckpt_dir = tempfile.mkdtemp(prefix="mesh_ckpt_", dir=scratch)
    try:
        t0 = time.perf_counter()
        path = save_checkpoint(ckpt_dir, TRAIN_STEPS, state)
        restored, manifest = restore_checkpoint(path, specs, state_sh)
        diff = _state_diff(restored, unshard_tree(state))
        print(f"mesh restore: step {manifest['step']} saved and placed back on the mesh in "
              f"{time.perf_counter() - t0:.1f} s; bit-identical: {not diff}")
        if diff or manifest["step"] != TRAIN_STEPS:
            fail(f"mesh restore: {len(diff)} leaves differ: {list(diff)[:4]}")
        del restored
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    del state, ref, batch_d

    # ---- the analysis against the card ----
    ana = analysis.analytic_cell(cfg, ShapeConfig("train", shape.seq_len,
                                                  shape.global_batch, "train"),
                                 chips=1, n_micro=n_micro, attention_impl="flash")
    compute_s = ana.flops_per_device / analysis.PEAK_FLOPS
    memory_s = ana.bytes_per_device / analysis.HBM_BW
    frac = max(compute_s, memory_s) * 1e3 / busy_ms if busy_ms else float("nan")
    print(f"mesh roofline: analytic compute {compute_s * 1e3:.3f} ms, memory "
          f"{memory_s * 1e3:.3f} ms (H100 constants, {ana.assumptions}); measured device "
          f"busy time of step 2 {busy_ms:.3f} ms; roofline_frac {frac:.4f} ({card})")
    if not (math.isfinite(frac) and 0 < frac <= ROOFLINE_MAX):
        fail(f"mesh roofline: roofline_frac {frac} outside (0, {ROOFLINE_MAX}]")
    release_memory("mesh serving")

    # ---- serving on the mesh against mesh=None: the same tokens ----
    params = model.init(torch.Generator("cuda").manual_seed(0))
    B, S = 4, 1024
    pshape = ShapeConfig("prefill_1k", S + MESH_DECODE_STEPS, B, "prefill")
    dshape = ShapeConfig("decode", S + MESH_DECODE_STEPS, B, "decode")
    tokens = torch.randint(2, cfg.vocab, (B, S), device="cuda",
                           generator=torch.Generator("cuda").manual_seed(1))
    served, serve_counts = {}, {}
    for label, m in (("mesh", mesh), ("none", None)):
        prefill, psh, _ = make_prefill_step(model, pshape, m)
        serve, ssh, _ = make_serve_step(model, dshape, m)
        p_args = ({"params": shard_tree(params, psh["params"]),
                   "tokens": shard_tree(tokens, psh["tokens"])} if m is not None
                  else {"params": params, "tokens": tokens})
        d_params = shard_tree(params, ssh["params"]) if m is not None else params
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        nxt, cache = prefill(p_args)
        if m is not None:
            cache = shard_tree(cache, ssh["cache"])
        out = [nxt]
        for i in range(MESH_DECODE_STEPS):
            tok = out[-1].long()
            if m is not None:
                tok = shard_tree(unshard_tree(tok), ssh["token"])
            nxt, cache = serve(d_params, cache, tok, S + i)
            out.append(nxt)
        out = torch.stack([unshard_tree(t) for t in out], 1)
        torch.cuda.synchronize()
        served[label] = (out, (time.perf_counter() - t0) * 1e3)
        serve_counts[label] = ops.launch_counts()
        del cache, p_args, d_params
    if not torch.equal(served["mesh"][0], served["none"][0]):
        fail("mesh serve: the mesh's tokens differ from mesh=None's")
    if serve_counts["mesh"] != serve_counts["none"]:
        fail(f"mesh serve: launches {serve_counts['mesh']} vs mesh=None's "
             f"{serve_counts['none']}")
    print(f"mesh serve: prefill B={B} S={S} then {MESH_DECODE_STEPS} decode steps, the same "
          f"{served['mesh'][0].numel()} tokens as mesh=None; host ms (first call, with "
          f"warm-up) mesh {served['mesh'][1]:.1f}, mesh=None {served['none'][1]:.1f}; "
          f"launches {serve_counts['mesh']}")
    del params
    dist.destroy_process_group()
    return launches, per_step, {"host_ms_mesh": ms_m, "host_ms_none": ms_0,
                                "busy_ms": busy_ms, "roofline_frac": frac,
                                "serve_launches": serve_counts["mesh"]}


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
    release_memory(VLM_CONFIG)
    vlm_launches, vlm_prefill, vlm_round = serve_phase(VLM_CONFIG)
    release_memory(AUDIO_CONFIG)
    audio_launches, audio_per, audio_round = audio_serve_phase()
    wide = {}
    for config, layers in WIDE_SERVE.items():
        release_memory(config)
        wide[config] = serve_phase(config, layers)
    release_memory(f"{GEMMA3_CONFIG}'s ring guard")
    ring = ring_guard_phase()
    trained = {}
    for config in TRAIN_CONFIGS:
        release_memory(f"training {config}")
        trained[config] = train_phase(config)
    release_memory("the mesh phase")
    mesh_launches, mesh_per_step, mesh_report = mesh_phase(card)

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
                **{path: t for path, t in timed.items()
                   if path.startswith(("whisper", "phi3v", "chatglm3", "qwen2", "mixtral"))},
                "launches_phi3v_serve": vlm_launches[name],
                "launches_per_phi3v_prefill": vlm_prefill[name],
                "launches_per_phi3v_decode_round": vlm_round[name],
                "launches_whisper_serve": audio_launches[name],
                "launches_per_whisper_prefill": audio_per["prefill"][name],
                "launches_per_whisper_cache_fill": audio_per["cache_fill"][name],
                "launches_per_whisper_decode_round": audio_round[name],
                **served_launches(name), **variant_launches(name),
                **train_launch_fields(name), **cws_launch_fields(name),
                **mesh_launch_fields(name)}

    def variant_launches(name):
        """The forward flash kernel's launches by variant on each path."""
        if name != "flash_fwd":
            return {}
        paths = {"serve": launches, "moe_serve": moe_launches,
                 "gemma3_serve": gemma_launches, "phi3v_serve": vlm_launches,
                 "whisper_serve": audio_launches,
                 **{f"{c}_serve": n for c, (n, _, _) in {**ssm, **wide}.items()}}
        return {"launches_by_variant": {
            "train": train_launches["by_variant"]["flash_fwd"],
            **{path: n["flash_fwd_variants"] for path, n in paths.items()},
            f"{LONG_CONFIG}_long_admission":
                wide[LONG_CONFIG][0]["long_admission"]["by_variant"]["flash_fwd"],
            f"{GEMMA3_CONFIG}_ring": ring["by_variant"]}}

    def served_launches(name):
        """The kernel's launches on each SSM and phase-12 serving path it
        runs in (mixtral-8x22b's long admission and gemma3-12b's ring among
        them)."""
        out = {}
        for config, (n, pre, rnd) in {**ssm, **wide}.items():
            if name in n:
                out.update({f"launches_{config}_serve": n[name],
                            f"launches_per_{config}_prefill": pre[name],
                            f"launches_per_{config}_decode_round": rnd[name]})
        for path, r in ((f"{LONG_CONFIG}_long_admission",
                         wide[LONG_CONFIG][0]["long_admission"]),
                        (f"{GEMMA3_CONFIG}_ring", ring)):
            if name in r["per_round"]:
                out.update({f"launches_{path}": r["launches"][name],
                            f"launches_per_{path}_prefill": r["per_prefill"][name],
                            f"launches_per_{path}_decode_round": r["per_round"][name]})
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

    def mesh_launch_fields(name):
        """The kernel's launches on the mesh train path (phase 14)."""
        return {"launches_mesh_train": {"total": mesh_launches[name],
                                        "per_step": mesh_per_step[name]}}

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
        # top level: the train step's shape; "paths" all the timed shapes
        return {"name": name, "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/flash_bwd.cu",
                "replaces": f"src/repro/kernels/flash_attention.py:{line}",
                "launches": train_launches[name], "max_abs_err": bwd_err[name],
                **bwd_t[name]["train"], "paths": bwd_t[name],
                "launches_by_variant": train_launches["by_variant"][name],
                "launches_per_train_step": per_step[name], **train_launch_fields(name),
                **cws_launch_fields(name), **mesh_launch_fields(name)}

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
         "launches_per_decode_round": moe_round["moe_gmm"], **served_launches("moe_gmm"),
         **train_launch_fields("moe_gmm")},
        # top level: mamba2-370m's prefill step shape; "launches" is the
        # mamba2-370m serving path's
        {**ssd_t["mamba2_prefill"], "name": "ssd_scan", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
         "replaces": "src/repro/kernels/ssd_scan.py:26",
         "launches": ssm["mamba2-370m"][0]["ssd_scan"], "max_abs_err": ssd_err,
         "library_ms": None, "library": "none: no single PyTorch call computes an SSD scan",
         "paths": ssd_t, **served_launches("ssd_scan"), **train_launch_fields("ssd_scan"),
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
    from repro_torch.launch import kernel_times
    print(f"device times taken with CUDA events, the profiler having recorded no "
          f"device event: {kernel_times.event_timed_readings} readings")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
