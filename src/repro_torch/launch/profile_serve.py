"""Where the serving time goes on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile_serve \
        [--config qwen3-moe-30b-a3b|mamba2-370m|zamba2-2.7b|phi-3-vision-4.2b|whisper-tiny|...]
        [--layers N]

Serves ``serve_workload``'s full burst (a full-width model, default
qwen1.5-0.5b, bf16, random weights from seed 0, 8 slots; ``--layers`` cuts
its depth, e.g. 12 for mixtral-8x22b's 60.9 GB) once to warm up,
once unprofiled, then again under ``torch.profiler``. Prints the
unprofiled wall time; for the profiled run the wall time split into
admission prefills and decode rounds (host clock, each call ending in a
synchronize), the device's busy time
(sum of kernel times on the one stream) and device time by kernel family;
the idle share of the unprofiled run (its wall time against the profiled
run's busy time: the profiler slows the host, not the kernels); the
kernels launched by one decode round; and one ``make_prefill_step`` call
at B=4, S=1024 (``chip_smoke.py``'s): its host time unprofiled, then its
device time by kernel family and its top kernels, and, traced with Python
stacks and input shapes, by the model function, op and shapes that
launched each kernel; for the SSM and hybrid configs also the device time
inside the ranges each Mamba block opens (``spans.span``) around itself and
the stages it calls by name (causal conv, dt and a, the SSD scan). A VLM's prefill step takes 576 patch rows
(``synthetic_extras``) before its 1024 tokens; its burst is text only. An
audio model (whisper-tiny), which the batcher does not serve, is profiled
on ``chip_smoke.py``'s path instead: the prefill step (the forward over
B=4, S=448 and 1500 frames), then 8 clips through ``encdec_serve_cache``
and 448 decode steps (4 prompt tokens, then greedy), once to warm up, once
unprofiled, once profiled. Where a profiler session records no device
event, a busy time is that of one more run between CUDA events
(``kernel_times.profiled_or_events``: the span, gaps included; the idle
shares and the breakdowns are then null), and ``device_time_from`` says
which. Needs a
CUDA card.
"""
from __future__ import annotations

import argparse
import json
import time
from collections import defaultdict

import numpy as np
import torch

from ..configs import get_config
from ..configs.base import ShapeConfig
from ..data import synthetic_extras
from ..kernels import ops
from ..models import build_model, mamba2
from ..runtime.serve import encdec_serve_cache, greedy_decode, make_prefill_step
from . import serve_workload
from .kernel_times import kernel_events, profiled_or_events, split_kernels

FAMILIES = (("flash_fwd", ("flash_fwd_kernel", "flash_fwd_tc_kernel", "flash_decode_kernel")),
            ("rmsnorm", ("rmsnorm_",)),
            ("moe_gmm", ("moe_gmm",)),
            ("ssd_scan", ("ssd_scan",)),      # both SSD kernels; before "scan", which it contains
            ("scan", ("scan",)),
            ("matmul", ("gemm", "gemv", "nvjet", "cutlass", "xmma", "cublas", "splitk")),
            ("index/copy", ("index", "copy", "scatter", "gather", "cat")),
            ("elementwise", ("elementwise", "vectorized", "reduce")))


def family(kernel_name: str) -> str:
    low = kernel_name.lower()
    for fam, keys in FAMILIES:
        if any(k in low for k in keys):
            return fam
    return "other"


def _split(prof):
    """→ (device busy µs, µs by family, µs by kernel name, kernel count)."""
    return split_kernels(prof, family)


def _ranges_ms(prof) -> dict:
    """Kernel ms inside each range a Mamba block opens (``mamba2.SPANS``):
    the kernels that run within the range's span on the device (so the
    ctypes-launched ones too); a stage's time is also in "mamba_block"'s."""
    names = set(mamba2.SPANS)
    spans = [(e.name, e.time_range) for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA and e.name in names]
    kernels = [(k.time_range.start, k.time_range.end) for k in kernel_events(prof)]
    out = defaultdict(float)
    for name, span in spans:
        out[name] += sum(end - start for start, end in kernels
                         if start >= span.start and end <= span.end) / 1e3
    return dict(out)


def _by_source(prof, n: int = 12) -> dict:
    """Device ms of the kernels PyTorch's own ops launched, by where they
    ran (the innermost model function, ``models/<file>(<def line>):
    <function>``, from the trace's Python events, else the innermost range
    of ``mamba2.SPANS``), the op and its input shapes; largest first."""
    ranges = set(mamba2.SPANS)
    out = defaultdict(float)
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CPU or not e.kernels:
            continue
        frame, q = "?", e.cpu_parent
        while q is not None:
            if "repro_torch/models/" in q.name:
                frame = q.name.split("repro_torch/")[-1]
                break
            if frame == "?" and q.name in ranges:
                frame = q.name
            q = q.cpu_parent
        for k in e.kernels:
            out[f"{frame} {e.name} {e.input_shapes} -> {k.name[:60]}"] += k.duration / 1e3
    return _top(out, 1, n)


def _top(d, scale, n=None):
    return {k: v / scale for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]}


class _Timed:
    """Wraps a model method: host wall time of each call, ending in a sync."""

    def __init__(self, fn):
        self.fn, self.seconds, self.calls = fn, 0.0, 0

    def __call__(self, *args, **kwargs):
        t0 = time.perf_counter()
        out = self.fn(*args, **kwargs)
        torch.cuda.synchronize()
        self.seconds += time.perf_counter() - t0
        self.calls += 1
        return out


def _prefill_step_report(model, step, batch) -> dict:
    """One prefill step after a warm-up call: its host ms unprofiled, then
    its device time by family, top kernels, the Mamba ranges and the
    launching sources, traced with Python stacks and input shapes."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    step(batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(batch)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    with torch.profiler.profile(activities=acts, record_shapes=True, with_stack=True) as prof:
        step(batch)
        torch.cuda.synchronize()
    step_us, step_family, step_kernel, step_n = _split(prof)
    step_us, timed_with, _ = profiled_or_events(step_us, lambda: step(batch), "the prefill step")
    traced = timed_with == "torch.profiler"
    return {"prefill_step_ms": step_ms,
            "prefill_step_device_ms": step_us / 1e3,
            "prefill_step_device_ms_from": timed_with,
            "prefill_step_kernels": step_n,
            "prefill_step_device_ms_by_family": _top(step_family, 1e3) if traced else None,
            "prefill_step_top_kernels_ms": _top(step_kernel, 1e3, 8) if traced else None,
            "prefill_step_ranges_ms": _ranges_ms(prof) if traced else None,
            "prefill_step_by_source_ms": _by_source(prof) if traced else None}


# whisper-tiny's serving path in chip_smoke.py: clips, prompt tokens fed by
# decode steps, decoder positions, the prefill step's (B, S)
AUDIO_CLIPS, AUDIO_PROMPT, AUDIO_MAX_LEN, AUDIO_PREFILL = 8, 4, 448, (4, 448)


def audio_main(model, params, seed: int) -> dict:
    """An audio model's serving profile: the prefill step, and clips served
    by ``encdec_serve_cache`` and greedy decode steps (the batcher serves no
    audio model)."""
    cfg = model.cfg
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    rng = np.random.default_rng(seed)
    frames = torch.from_numpy(synthetic_extras("audio", AUDIO_CLIPS, cfg, rng)["frames"]
                              ).cuda().bfloat16()
    prompt = torch.from_numpy(rng.integers(2, cfg.vocab, (AUDIO_CLIPS, AUDIO_PROMPT))).cuda()

    def serve():
        t0 = time.perf_counter()
        cache = encdec_serve_cache(model, params, frames, AUDIO_MAX_LEN)
        torch.cuda.synchronize()
        fill_s = time.perf_counter() - t0
        greedy_decode(model, params, cache, prompt, 0, AUDIO_MAX_LEN)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, fill_s

    serve()                                                           # warm-up
    plain_s, plain_fill_s = serve()
    with torch.profiler.profile(activities=acts) as prof:
        wall, fill_s = serve()
    busy_us, by_family, by_kernel, n_kernels = _split(prof)
    busy_us, timed_with, idle = profiled_or_events(
        busy_us, serve, "the audio serving path",
        unprofiled_device_idle_share=plain_s, device_idle_share=wall)
    traced = timed_with == "torch.profiler"
    cache = encdec_serve_cache(model, params, frames, AUDIO_MAX_LEN)
    with torch.profiler.profile(activities=acts) as prof:
        model.decode_step(params, cache, prompt[:, 0], 0)
        torch.cuda.synchronize()
    per_round = len(kernel_events(prof))
    pb, ps = AUDIO_PREFILL
    step, _, _ = make_prefill_step(model, ShapeConfig("prefill_448", ps, pb, "prefill"))
    batch = {"params": params, "frames": frames[:pb], "tokens": torch.from_numpy(
        rng.integers(2, cfg.vocab, (pb, ps))).cuda()}
    tokens = AUDIO_CLIPS * AUDIO_MAX_LEN
    return {
        "device": torch.cuda.get_device_name(0), "config": cfg.name,
        "path": f"{AUDIO_CLIPS} clips of {cfg.encdec.n_frames} frames: encdec_serve_cache, "
                f"{AUDIO_MAX_LEN} decode steps ({AUDIO_PROMPT} prompt tokens, then greedy)",
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "unprofiled_wall_s": plain_s, "unprofiled_cache_fill_s": plain_fill_s,
        "unprofiled_tok_per_s": tokens / plain_s,
        "kernels_per_decode_round": per_round,
        "wall_s": wall, "cache_fill_s": fill_s, "tokens": tokens,
        "device_busy_s": busy_us / 1e6, **idle,
        "device_time_from": timed_with, "kernels": n_kernels,
        "device_s_by_family": _top(by_family, 1e6) if traced else None,
        "top_kernels_s": _top(by_kernel, 1e6, 8) if traced else None,
        **_prefill_step_report(model, step, batch)}


def main(seed: int = 0, config: str = serve_workload.DEFAULT_CONFIG,
         layers: int = 0) -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("profile_serve needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(config)
    model = build_model(cfg.scaled(n_layers=layers) if layers else cfg, "cuda")
    params = model.init(torch.Generator("cuda").manual_seed(seed))
    if model.cfg.family == "audio":
        report = audio_main(model, params, seed)
        print(json.dumps(report, indent=1))
        return report
    serve_workload.run(model, params, smoke=False, seed=seed)        # warm-up
    plain = serve_workload.run(model, params, smoke=False, seed=seed)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    # kernels of one decode round at 8 slots
    cache = model.init_cache(8, 2048)
    tok = torch.zeros(8, dtype=torch.int64, device="cuda")
    with torch.profiler.profile(activities=acts) as prof:
        model.decode_step(params, cache, tok, 100)
        torch.cuda.synchronize()
    per_round = len(kernel_events(prof))

    # one prefill step at B=4, S=1024 (a VLM's after its patches)
    step, _, _ = make_prefill_step(model, ShapeConfig("prefill_1k", 1024, 4, "prefill"))
    batch = {"params": params, "tokens": torch.randint(
        2, model.cfg.vocab, (4, 1024), device="cuda",
        generator=torch.Generator("cuda").manual_seed(1))}
    batch.update({k: torch.from_numpy(v).cuda() for k, v in synthetic_extras(
        model.cfg.family, 4, model.cfg, np.random.default_rng(seed)).items()})
    step_report = _prefill_step_report(model, step, batch)

    prefill, decode = _Timed(model.prefill_into), _Timed(model.decode_step)
    model.prefill_into, model.decode_step = prefill, decode
    with torch.profiler.profile(activities=acts) as prof:
        out = serve_workload.run(model, params, smoke=False, seed=seed)
    rounds = {"prefill_calls": prefill.calls, "prefill_s": prefill.seconds,
              "decode_rounds": decode.calls, "decode_s": decode.seconds,
              "decode_ms_per_round": 1e3 * decode.seconds / max(decode.calls, 1)}
    busy_us, by_family, by_kernel, n_kernels = _split(prof)
    wall = out["seconds"]
    busy_us, timed_with, idle = profiled_or_events(
        busy_us, lambda: serve_workload.run(model, params, smoke=False, seed=seed), "the burst",
        unprofiled_device_idle_share=plain["seconds"], device_idle_share=wall)
    traced = timed_with == "torch.profiler"
    report = {
        "device": torch.cuda.get_device_name(0), "config": config,
        "layers": model.cfg.n_layers,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "unprofiled_wall_s": plain["seconds"],
        "unprofiled_tok_per_s": plain["tokens"] / plain["seconds"],
        "kernels_per_decode_round": per_round,
        "wall_s": wall, "tokens": out["tokens"], "tok_per_s": out["tokens"] / wall, **rounds,
        "device_busy_s": busy_us / 1e6, **idle,
        "device_time_from": timed_with, "kernels": n_kernels,
        "device_s_by_family": _top(by_family, 1e6) if traced else None,
        "top_kernels_s": _top(by_kernel, 1e6, 8) if traced else None,
        **step_report,
    }
    print(json.dumps(report, indent=1))
    return report


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--config", default=serve_workload.DEFAULT_CONFIG,
                    help="model config name")
    ap.add_argument("--layers", type=int, default=0, help="layers to serve (0: all)")
    a = ap.parse_args()
    main(a.seed, a.config, a.layers)
