"""Device time of the port's kernels at the serving path's shapes.

    PYTHONPATH=src python -m repro_torch.launch.kernel_times [--repeats 3]

Times each kernel of the serving path on the card: flash attention at the
prefill shape (B=4, S=T=1024, 16 heads of 64, causal) and at the decode
shape (B=8, S=1, T=2048, kv_len 1..2048), RMSNorm at 4096 and at 8 rows of
1024, all bf16. A time is the summed duration of what one call runs on the
device, traced by ``torch.profiler``; host time between launches does not
count. Prints one JSON line with ``--repeats`` readings per kernel and
shape. To compare two versions of a kernel, run this from both checkouts in
one call to the card, alternating. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json

import torch

from ..kernels.flash_attention import flash_attention_cuda
from ..kernels.rmsnorm import rmsnorm_cuda


# Now and then a profiler session on the card records no device event at
# all (seen once in a process's first session on an H100): trace again
PROFILER_SESSIONS = 3


def device_ms(fn, iters: int = 20, warmup: int = 3, kernel: str = "") -> float:
    """Mean device time of one call of ``fn`` over ``iters`` calls: the
    summed durations of the kernels (and device copies) it runs, or of
    those whose name contains ``kernel``. Traces up to
    ``PROFILER_SESSIONS`` times and raises if none records a device event."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(PROFILER_SESSIONS):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        if events:
            us = sum(e.time_range.elapsed_us() for e in events if kernel in e.name)
            if us <= 0:
                raise RuntimeError(f"torch.profiler recorded no device time for "
                                   f"{kernel!r}")
            return us / iters / 1e3
    raise RuntimeError(f"torch.profiler recorded no device event in "
                       f"{PROFILER_SESSIONS} sessions")


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


def main(repeats: int = 3) -> dict:
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
    calls = {
        "flash_fwd prefill": lambda: flash_attention_cuda(qp, kp, vp, causal=True,
                                                          window=0),
        "flash_fwd decode": lambda: flash_attention_cuda(qd, kd, vd, causal=False,
                                                         window=0, kv_len=kv_len),
        "rmsnorm 4096x1024": lambda: rmsnorm_cuda(xp, scale),
        "rmsnorm 8x1024": lambda: rmsnorm_cuda(xd, scale),
    }
    out = {name: [] for name in calls}
    for _ in range(repeats):
        for name, fn in calls.items():
            out[name].append(device_ms(fn, iters=50))
    report = {"device": torch.cuda.get_device_name(0), "device_ms": out}
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeats", type=int, default=3)
    main(ap.parse_args().repeats)
