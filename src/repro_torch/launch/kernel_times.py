"""Device time of the port's kernels at the serving and training paths' shapes.

    PYTHONPATH=src python -m repro_torch.launch.kernel_times [--repeats 3] [--only NAME]
        [--ssd-heads] [--events]

Times each kernel of the serving paths on the card, all bf16. qwen1.5-0.5b:
flash attention at the prefill shape (B=4, S=T=1024, 16 heads of 64,
causal) and at the decode shape (B=8, S=1, T=2048, kv_len 1..2048), RMSNorm
at 4096 and at 8 rows of 1024. qwen3-moe-30b-a3b: flash attention at the
same two shapes with 32 query and 4 KV heads of 128, RMSNorm at d = 2048,
and the grouped expert GEMM of one MoE layer (128 experts, d 2048, ff 768)
at a decode round of 8 slots (C = 8), a 511-token and a 256-token
admission (C = 40, 256) and the prefill step (C = 320), gate/up
(2048 -> 768) and down (768 -> 2048); mixtral-8x22b's experts (8, d 6144,
ff 16384) at its decode rounds' C = 1 (one slot) and 8, gate/up and down;
each decode shape beside ``torch.bmm`` of the same product. The SSD scan
at mamba2-370m's prefill step (B=4, S=1024, 32 heads of 64, N=128), at
zamba2-2.7b's (80 heads, N=64) and at one 511-token mamba2-370m
admission; flash attention at
zamba2-2.7b's 32 heads of 80 (prefill and decode shapes as above), RMSNorm
at 4096 and 8 rows of its d_inner 5120. gemma3-12b: flash attention at 16
query and 8 KV heads of 256 at the prefill shape (window 1024) and the
decode shape, RMSNorm at 4096 and 8 rows of d 3840. The flash
backward (dq and dk/dv, O and lse from the forward kernel) at the train
step's shape (B=4, S=T=1024, 16 heads of 64, causal) and with qwen3-moe's
32 query and 4 KV heads of 128. The training backward of the MoE and SSM
families: the grouped GEMM's dX (dy·wᵀ) and dW (bufᵀ·dy) at qwen3-moe's
train microbatch (4 x 1024 tokens: C = 320 a expert), gate/up and down,
each beside ``torch.bmm`` of the same product (mixtral-8x22b's at its
train microbatch too: C = 1280, ``MIXTRAL_TRAIN_C``; ``--only moe_gmm_d``
times the eight backward products), and the SSD backward at
mamba2-370m's and zamba2-2.7b's train microbatch (B=4, S=1024; 32 heads,
N=128 and 80 heads, N=64), by variant: ``tc`` on bf16 inputs, whole and
each of its three kernels (``SSD_BWD_TC_STAGES``), and ``fma`` on the same
values in f32. ``--only`` times the calls whose name
contains it (``--only flash_bwd`` runs on a checkout whose forward lacks
D = 256). ``--ssd-heads`` also times the bf16 SSD kernels at each number of
heads a block can take at their shapes (a divisor of H/G up to
``ssd_scan.TC_MAX_HEADS``, ``TC_BWD_MAX_HEADS`` for the backward;
``ssd_scan._heads_per_block`` and ``_bwd_heads_per_block`` pick one).
``--cold`` also times every call with L2 flushed before it, under its name
and " (L2 flushed)". A time is the summed
duration of what one call runs on the device, traced by
``torch.profiler`` (CUDA events around the call where the profiler
records nothing); host time between launches does not count. ``--events``
also times every call with ``event_ms``, the fallback, under its name
and " (CUDA events)". Prints one JSON line with ``--repeats`` readings per
kernel and shape. To compare two versions of a kernel, run this from both checkouts in
one call to the card, alternating. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from ..kernels.flash_attention import (
    _delta, flash_attention_cuda, flash_bwd_dkv_cuda, flash_bwd_dq_cuda)
from ..kernels.moe_gmm import moe_gmm_cuda, moe_gmm_dw_cuda, moe_gmm_dx_cuda
from ..kernels import ssd_scan
from ..kernels.rmsnorm import rmsnorm_cuda
from ..kernels.ssd_scan import ssd_scan_bwd_cuda, ssd_scan_cuda

# qwen3-moe-30b-a3b's MoE layer: experts, d_model, d_ff_expert; tokens per
# expert in a decode round of 8 slots, in a 511-token and a 256-token
# admission and in a B=4 x S=1024 prefill step
MOE_E, MOE_D, MOE_F = 128, 2048, 768
MOE_C = {"decode": 8, "admit511": 40, "admit256": 256, "prefill": 320}
# mixtral-8x22b's experts, d_model, d_ff; tokens per expert in its decode
# rounds at one slot and at 8
MIXTRAL_E, MIXTRAL_D, MIXTRAL_F = 8, 6144, 16384
MIXTRAL_DECODE_C = (1, 8)
# tokens per expert in a train microbatch of 4 x 1024 tokens:
# round(4096 · 8 / 128 · 1.25); mixtral-8x22b's: round(4096 · 2 / 8 · 1.25)
MOE_TRAIN_C = 320
MIXTRAL_TRAIN_C = 1280
# the SSD scan's main-path shapes (B, S, H, P, G, N)
SSD_PATHS = {"mamba2_prefill": (4, 1024, 32, 64, 1, 128),
             "zamba2_prefill": (4, 1024, 80, 64, 1, 64),
             "mamba2_admission": (1, 511, 32, 64, 1, 128)}
# the SSD backward's: a train microbatch of each SSM config
SSD_TRAIN_PATHS = {"mamba2_train": (4, 1024, 32, 64, 1, 128),
                   "zamba2_train": (4, 1024, 80, 64, 1, 64)}
# the bf16 SSD backward's three kernels, by a part of their names
SSD_BWD_TC_STAGES = {"states": "ssd_scan_bwd_tc_states", "chain": "ssd_scan_bwd_tc_chain",
                     "gradients": "ssd_scan_bwd_tc_kernel"}


# Now and then a profiler session on the card records no device event at
# all: seen in a process's first session on an H100, and in three sessions
# running just after three that recorded. ``device_ms`` traces again up to
# ``PROFILER_SESSIONS`` times, then times the call with CUDA events
PROFILER_SESSIONS = 3
# how many ``device_ms`` readings in this process were timed with CUDA events
event_timed_readings = 0


# ``event_ms``'s sleeping kernel: an H100's SM clock at most (a slower
# clock sleeps longer), and the longest it sleeps
SLEEP_CYCLES_PER_S = 1.98e9
EVENT_HOLD_S = 0.2


# bytes written between the calls of a cold reading: more than an H100's
# 50 MB L2, so that a call's inputs come from device memory
L2_FLUSH_BYTES = 256 << 20


def device_events(fn, iters: int = 1):
    """The device events of ``iters`` calls of ``fn``, traced by
    ``torch.profiler``; traces up to ``PROFILER_SESSIONS`` times, and
    returns None if no session records a device event."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(PROFILER_SESSIONS):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        if events:
            return events
    return None


def event_ms(fn, iters: int = 1, before=None) -> float:
    """Mean time of one call of ``fn`` between CUDA events recorded just
    before and just after it, with ``before`` (untimed) ahead of each call.
    The calls queue behind a kernel that sleeps for twice the host's time
    to queue them (at most ``EVENT_HOLD_S``), so that a span holds the
    device's time rather than the host's launches; it also holds the gaps
    between the call's kernels: at least the call's device time."""
    t0 = time.perf_counter()
    if before is not None:
        before()
    fn()
    hold_s = min(2 * iters * (time.perf_counter() - t0), EVENT_HOLD_S)
    torch.cuda.synchronize()
    torch.cuda._sleep(int(hold_s * SLEEP_CYCLES_PER_S))
    spans = []
    for _ in range(iters):
        if before is not None:
            before()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        spans.append((start, end))
    torch.cuda.synchronize()
    return sum(start.elapsed_time(end) for start, end in spans) / iters


def device_ms(fn, iters: int = 20, warmup: int = 3, kernel: str = "",
              cold: bool = False) -> float:
    """Mean device time of one call of ``fn`` over ``iters`` calls: the
    summed durations of the kernels (and device copies) it runs, or of
    those whose name contains ``kernel``. With ``cold``, each call follows
    a write of ``L2_FLUSH_BYTES``, whose own device events are left out:
    the time of a call whose inputs are not in L2 (back to back, a call
    whose inputs fit in L2 reads them from there). Where the profiler
    records no device event, the reading is ``event_ms`` of the whole call
    (``kernel`` then selects nothing), and ``event_timed_readings`` counts
    it."""
    global event_timed_readings
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    step, flush, flush_names = fn, None, set()
    if cold:
        scratch = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
        flush = scratch.zero_
        flush_events, fn_events = device_events(flush), device_events(fn)
        if flush_events is None or fn_events is None:
            step = None
        else:
            flush_names = {e.name for e in flush_events}
            if flush_names & {e.name for e in fn_events}:
                raise RuntimeError(f"device_ms: the L2 flush's kernels {flush_names} "
                                   f"are among the timed call's")

            def step():
                flush()
                fn()
    events = device_events(step, iters) if step is not None else None
    if events is None:
        event_timed_readings += 1
        return event_ms(fn, iters, before=flush)
    us = sum(e.time_range.elapsed_us() for e in events
             if kernel in e.name and e.name not in flush_names)
    if us <= 0:
        raise RuntimeError(f"torch.profiler recorded no device time for {kernel!r}")
    return us / iters / 1e3


def profiled_or_events(busy_us: float, fn, what: str, **wall_s: float):
    """``busy_us``, the device time that a profiled run of ``fn`` recorded;
    or, where ``torch.profiler`` recorded no device event (as ``device_ms``
    meets now and then), the time of ``fn`` run once more between CUDA
    events (``event_ms``: its device span, gaps between kernels included),
    with a line that says so. Each ``wall_s`` (name=seconds) gives an idle
    share, 1 - busy / wall; None where the time is a span, which holds the
    host's gaps and so reads no idle share. → (µs, "torch.profiler" or
    "CUDA events", {name: idle share or None})."""
    if busy_us > 0:
        return busy_us, "torch.profiler", {k: 1.0 - busy_us / 1e6 / s for k, s in wall_s.items()}
    print(f"{what}: torch.profiler recorded no device event; timed with CUDA events "
          f"instead (the span holds the gaps between kernels: no idle share, no breakdown)",
          flush=True)
    return event_ms(fn) * 1e3, "CUDA events", dict.fromkeys(wall_s)


def wrapper_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean time of one call of ``fn`` back to back, CUDA events around the
    run: where a launch is shorter than the call, this is the host's time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _with_heads(fn, heads: int, picker: str = "_heads_per_block"):
    """``fn`` with the bf16 SSD kernel's blocks (the backward's, for
    ``picker="_bwd_heads_per_block"``) taking ``heads`` heads."""
    def call():
        saved = getattr(ssd_scan, picker)
        setattr(ssd_scan, picker, lambda *args: heads)
        try:
            return fn()
        finally:
            setattr(ssd_scan, picker, saved)
    return call


def _bwd_calls(calls: dict, label: str, *inputs) -> None:
    """The grouped GEMM's dX (dy·wᵀ) and dW (bufᵀ·dy) on (buf, w, dy), and
    ``torch.bmm`` of each product, under names that hold "moe_gmm_dx" or
    "moe_gmm_dw" and ``label``; ``inputs`` is (buf, w, dy) or a function
    that makes them."""
    get = inputs[0] if len(inputs) == 1 else lambda: inputs
    calls[f"moe_gmm_dx {label}"] = lambda: moe_gmm_dx_cuda(get()[2], get()[1])
    calls[f"moe_gmm_dw {label}"] = lambda: moe_gmm_dw_cuda(get()[0], get()[2])
    calls[f"moe_gmm_dx {label} torch.bmm"] = lambda: torch.bmm(get()[2], get()[1].transpose(1, 2))
    calls[f"moe_gmm_dw {label} torch.bmm"] = lambda: torch.bmm(get()[0].transpose(1, 2), get()[2])


def main(repeats: int = 3, only: str = "", ssd_heads: bool = False,
         events: bool = False, cold: bool = False) -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("kernel_times needs a CUDA card")
    gen = torch.Generator("cuda").manual_seed(0)
    bf16, H, D = torch.bfloat16, 16, 64

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(bf16)

    qp, kp, vp = randn(4, 1024, H, D), randn(4, 1024, H, D), randn(4, 1024, H, D)
    qd, kd, vd = randn(8, 1, H, D), randn(8, 2048, H, D), randn(8, 2048, H, D)
    kv_len = torch.linspace(1, 2048, 8, device="cuda").round().to(torch.int32)
    xp, xd, scale = randn(4096, 1024), randn(8, 1024), randn(1024)
    # qwen3-moe-30b-a3b: GQA 8:1 at D = 128, d = 2048, one layer's experts
    qp2, kp2, vp2 = randn(4, 1024, 32, 128), randn(4, 1024, 4, 128), randn(4, 1024, 4, 128)
    qd2, kd2, vd2 = randn(8, 1, 32, 128), randn(8, 2048, 4, 128), randn(8, 2048, 4, 128)
    xp2, xd2, scale2 = randn(4096, 2048), randn(8, 2048), randn(2048)
    w_up, w_down = randn(MOE_E, MOE_D, MOE_F), randn(MOE_E, MOE_F, MOE_D)
    bufs = {path: (randn(MOE_E, c, MOE_D), randn(MOE_E, c, MOE_F))
            for path, c in MOE_C.items()}
    # zamba2-2.7b: its shared block's 32 heads of 80, its gated norm
    qp3, kp3, vp3 = randn(4, 1024, 32, 80), randn(4, 1024, 32, 80), randn(4, 1024, 32, 80)
    qd3, kd3, vd3 = randn(8, 1, 32, 80), randn(8, 2048, 32, 80), randn(8, 2048, 32, 80)
    xp3, xd3, scale3 = randn(4096, 5120), randn(8, 5120), randn(5120)
    # gemma3-12b: d_model 3840, 16 query and 8 KV heads of 256
    xp4, xd4, scale4 = randn(4096, 3840), randn(8, 3840), randn(3840)
    qp4, kp4, vp4 = randn(4, 1024, 16, 256), randn(4, 1024, 8, 256), randn(4, 1024, 8, 256)
    qd4, kd4, vd4 = randn(8, 1, 16, 256), randn(8, 2048, 8, 256), randn(8, 2048, 8, 256)
    # the flash backward's inputs: (q, k, v, dO, lse, Δ), O and lse from the
    # forward kernel
    bwd = {}
    for path, (Hq, Hkv, Dh) in (("train", (16, 16, 64)), ("GQA 32:4 D=128", (32, 4, 128))):
        q, k, v, do = randn(4, 1024, Hq, Dh), randn(4, 1024, Hkv, Dh), \
            randn(4, 1024, Hkv, Dh), randn(4, 1024, Hq, Dh)
        o, lse = flash_attention_cuda(q, k, v, causal=True, window=0)
        bwd[path] = (q, k, v, do, lse, _delta(o, do).contiguous())
    ssd = {}
    for path, (B, S, Hs, P, G, N) in {**SSD_PATHS, **SSD_TRAIN_PATHS}.items():
        dt = (1e-3 + 0.099 * torch.rand(B, S, Hs, generator=gen, device="cuda")).to(bf16)
        a = -(1 + 15 * torch.rand(Hs, generator=gen, device="cuda")).to(bf16)
        ssd[path] = (randn(B, S, Hs, P), dt, a, 0.5 * randn(B, S, G, N),
                     0.5 * randn(B, S, G, N))
    calls = {
        "flash_fwd prefill": lambda: flash_attention_cuda(qp, kp, vp, causal=True,
                                                          window=0),
        "flash_fwd decode": lambda: flash_attention_cuda(qd, kd, vd, causal=False,
                                                         window=0, kv_len=kv_len),
        "rmsnorm 4096x1024": lambda: rmsnorm_cuda(xp, scale),
        "rmsnorm 8x1024": lambda: rmsnorm_cuda(xd, scale),
        "flash_fwd prefill GQA 32:4 D=128": lambda: flash_attention_cuda(
            qp2, kp2, vp2, causal=True, window=0),
        "flash_fwd decode GQA 32:4 D=128": lambda: flash_attention_cuda(
            qd2, kd2, vd2, causal=False, window=0, kv_len=kv_len),
        "rmsnorm 4096x2048": lambda: rmsnorm_cuda(xp2, scale2),
        "rmsnorm 8x2048": lambda: rmsnorm_cuda(xd2, scale2),
        "flash_fwd prefill H=32 D=80": lambda: flash_attention_cuda(
            qp3, kp3, vp3, causal=True, window=0),
        "flash_fwd decode H=32 D=80": lambda: flash_attention_cuda(
            qd3, kd3, vd3, causal=False, window=0, kv_len=kv_len),
        "rmsnorm 4096x5120": lambda: rmsnorm_cuda(xp3, scale3),
        "rmsnorm 8x5120": lambda: rmsnorm_cuda(xd3, scale3),
        "rmsnorm 4096x3840": lambda: rmsnorm_cuda(xp4, scale4),
        "rmsnorm 8x3840": lambda: rmsnorm_cuda(xd4, scale4),
        "flash_fwd prefill GQA 16:8 D=256 window 1024": lambda: flash_attention_cuda(
            qp4, kp4, vp4, causal=True, window=1024),
        "flash_fwd decode GQA 16:8 D=256": lambda: flash_attention_cuda(
            qd4, kd4, vd4, causal=False, window=0, kv_len=kv_len),
    }
    for path, ins in bwd.items():
        calls[f"flash_bwd_dq {path}"] = lambda ins=ins: flash_bwd_dq_cuda(
            *ins, causal=True, window=0)
        calls[f"flash_bwd_dkv {path}"] = lambda ins=ins: flash_bwd_dkv_cuda(
            *ins, causal=True, window=0)
    kernels = {}   # a call's name -> the device kernels it is timed by
    for path in SSD_TRAIN_PATHS:
        ins = (*ssd.pop(path), randn(*SSD_TRAIN_PATHS[path][:4]))      # and dy
        f32 = tuple(t.float() for t in ins)
        calls[f"ssd_scan_bwd {path} tc"] = lambda ins=ins: ssd_scan_bwd_cuda(*ins)
        for stage, kernel in SSD_BWD_TC_STAGES.items():
            calls[f"ssd_scan_bwd {path} tc {stage}"] = calls[f"ssd_scan_bwd {path} tc"]
            kernels[f"ssd_scan_bwd {path} tc {stage}"] = kernel
        calls[f"ssd_scan_bwd {path} fma (f32 inputs)"] = lambda f32=f32: ssd_scan_bwd_cuda(*f32)
        _, _, Hs, _, G, _ = SSD_TRAIN_PATHS[path]
        for heads in range(1, ssd_scan.TC_BWD_MAX_HEADS + 1) if ssd_heads else ():
            if (Hs // G) % heads == 0:
                calls[f"ssd_scan_bwd {path} tc heads={heads}"] = _with_heads(
                    lambda ins=ins: ssd_scan_bwd_cuda(*ins), heads, "_bwd_heads_per_block")
    for part, (w, d_in) in (("gate/up", (w_up, MOE_D)), ("down", (w_down, MOE_F))):
        buf, dy = randn(MOE_E, MOE_TRAIN_C, d_in), randn(MOE_E, MOE_TRAIN_C, w.shape[2])
        _bwd_calls(calls, f"train {part} C={MOE_TRAIN_C}", buf, w, dy)
    mixtral_train = {}   # its w (1.61 GB a part), buf and dy, made at first use

    def mixtral_train_inputs(part):
        if part not in mixtral_train:
            mixtral_train.clear()   # one part's inputs at a time
            d_in, d_out = (MIXTRAL_D, MIXTRAL_F) if part == "gate/up" else (MIXTRAL_F, MIXTRAL_D)
            mixtral_train[part] = (randn(MIXTRAL_E, MIXTRAL_TRAIN_C, d_in),
                                   randn(MIXTRAL_E, d_in, d_out),
                                   randn(MIXTRAL_E, MIXTRAL_TRAIN_C, d_out))
        return mixtral_train[part]
    for part in ("gate/up", "down"):
        _bwd_calls(calls, f"mixtral train {part} C={MIXTRAL_TRAIN_C}",
                   lambda part=part: mixtral_train_inputs(part))
    for path, ins in ssd.items():
        calls[f"ssd_scan {path}"] = lambda ins=ins: ssd_scan_cuda(*ins)
        _, _, Hs, _, G, _ = SSD_PATHS[path]
        for heads in range(1, ssd_scan.TC_MAX_HEADS + 1) if ssd_heads else ():
            if (Hs // G) % heads == 0:
                calls[f"ssd_scan {path} heads={heads}"] = _with_heads(
                    lambda ins=ins: ssd_scan_cuda(*ins), heads)
    for path, (x_d, x_f) in bufs.items():
        calls[f"moe_gmm {path} gate/up C={MOE_C[path]}"] = \
            lambda x=x_d: moe_gmm_cuda(x, w_up)
        calls[f"moe_gmm {path} down C={MOE_C[path]}"] = \
            lambda x=x_f: moe_gmm_cuda(x, w_down)
    calls["moe_gmm decode gate/up C=8 torch.bmm"] = lambda: torch.bmm(bufs["decode"][0], w_up)
    calls["moe_gmm decode down C=8 torch.bmm"] = lambda: torch.bmm(bufs["decode"][1], w_down)
    mixtral = {}   # its w (1.61 GB a part) and bufs, made at first use

    def mixtral_inputs(part, c):
        if (part, c) not in mixtral:
            d_in, d_out = (MIXTRAL_D, MIXTRAL_F) if part == "gate/up" else (MIXTRAL_F, MIXTRAL_D)
            if part not in mixtral:
                mixtral[part] = randn(MIXTRAL_E, d_in, d_out)
            mixtral[(part, c)] = randn(MIXTRAL_E, c, d_in)
        return mixtral[(part, c)], mixtral[part]
    for c in MIXTRAL_DECODE_C:
        for part in ("gate/up", "down"):
            calls[f"moe_gmm mixtral decode {part} C={c}"] = \
                lambda part=part, c=c: moe_gmm_cuda(*mixtral_inputs(part, c))
            calls[f"moe_gmm mixtral decode {part} C={c} torch.bmm"] = \
                lambda part=part, c=c: torch.bmm(*mixtral_inputs(part, c))
    calls = {name: fn for name, fn in calls.items() if only in name}
    out = {name: [] for name in calls}
    out.update({f"{name} (CUDA events)": [] for name in calls if events})
    out.update({f"{name} (L2 flushed)": [] for name in calls if cold})
    for _ in range(repeats):
        for name, fn in calls.items():
            out[name].append(device_ms(fn, iters=50, kernel=kernels.get(name, "")))
            if events:
                out[f"{name} (CUDA events)"].append(event_ms(fn, iters=50))
            if cold:
                out[f"{name} (L2 flushed)"].append(
                    device_ms(fn, iters=20, kernel=kernels.get(name, ""), cold=True))
    report = {"device": torch.cuda.get_device_name(0), "device_ms": out}
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--only", default="", help="time only the calls whose name contains this")
    ap.add_argument("--ssd-heads", action="store_true",
                    help="also time the bf16 SSD kernels at each heads-per-block choice")
    ap.add_argument("--events", action="store_true",
                    help="also time every call with CUDA events (device_ms's fallback)")
    ap.add_argument("--cold", action="store_true",
                    help="also time every call with L2 flushed before it")
    args = ap.parse_args()
    main(args.repeats, args.only, args.ssd_heads, args.events, args.cold)
