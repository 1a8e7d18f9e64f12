"""The traced part of a ``--trace 1`` run: one ``torch.profiler`` session
of the card's activity (kernels and copies, no host operations, so the
host runs at nearly its own pace) over a stretch of the window, read for
the device's busy time (the union of its intervals), its heaviest
operations, and its idle gaps named by the benchmark's span the host was
in. Spans are the harness's own, around its calls into the program
(``Session.span``, ``spans_on``), kept in memory on the host's clock;
nothing is added inside the program."""
from __future__ import annotations

import bisect
import contextlib
import functools
import time
from collections import defaultdict
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

TOP = 10
# a traced stretch of the window: it opens at this share of the window
# and lasts this many seconds, or this share of the window if less
TRACE_FROM = 0.3
TRACE_SECONDS = 4.0
TRACE_SHARE = 0.4


def traced_stretch(seconds: float) -> Tuple[float, float]:
    """(opens, closes) seconds into the window."""
    start = TRACE_FROM * seconds
    return start, start + min(TRACE_SECONDS, TRACE_SHARE * seconds)


@contextlib.contextmanager
def spans_on(session: Optional["Session"], targets: List[Tuple[Any, str, str]]):
    """With a session, wrap each (object, attribute, span name) in a span
    for the life of the block (an attribute set on the object, put back
    after); without one, change nothing."""
    saved = []
    for obj, attr, name in (targets if session else []):
        saved.append((obj, attr, obj.__dict__.get(attr), attr in obj.__dict__))
        setattr(obj, attr, session.wrap(getattr(obj, attr), name))
    try:
        yield
    finally:
        for obj, attr, old, had in reversed(saved):
            if had:
                setattr(obj, attr, old)
            else:
                delattr(obj, attr)


def span(session: Optional["Session"], name: str):
    """``session.span(name)``, or nothing without a session."""
    return session.span(name) if session else contextlib.nullcontext()


def _profile(device: str = "cuda"):
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CUDA if device == "cuda" else ProfilerActivity.CPU])


def _device_events(prof) -> list:
    return [e for e in prof.profiler.kineto_results.events()
            if e.device_type() == torch.autograd.DeviceType.CUDA and not e.is_user_annotation()]


def prime(tries: int = 3) -> bool:
    """A first profiler session on the card can record no device event:
    trace a small operation until one is recorded. → whether one was."""
    x = torch.ones(1 << 20, device="cuda")
    for _ in range(tries):
        with _profile() as prof:
            (x * 2).sum()
            torch.cuda.synchronize()
        if _device_events(prof):
            return True
    return False


class Session:
    """One profiler session: ``open()`` and ``close()`` synchronise the
    card, so the window holds all of the traced work."""

    def __init__(self, device: str = "cuda") -> None:
        self.device = device
        self.prof = None
        self.t0_ns = self.t1_ns = 0
        self.spans: List[Tuple[int, int, str]] = []

    @contextlib.contextmanager
    def span(self, name: str):
        t = time.time_ns()
        try:
            yield
        finally:
            self.spans.append((t, time.time_ns(), name))

    def wrap(self, fn: Callable, name: str) -> Callable:
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with self.span(name):
                return fn(*args, **kwargs)
        return wrapped

    def _sync(self) -> None:
        if self.device == "cuda":
            torch.cuda.synchronize()

    def open(self) -> None:
        self._sync()
        self.prof = _profile(self.device)
        self.prof.start()
        self.t0_ns = time.time_ns()

    def close(self) -> None:
        self._sync()
        self.t1_ns = time.time_ns()
        self.prof.stop()

    @property
    def is_open(self) -> bool:
        return self.prof is not None and self.t1_ns == 0

    def read(self) -> Dict[str, Any]:
        """``reduce`` of this session's device events and spans."""
        dev = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
               for e in _device_events(self.prof)]
        return reduce(dev, self.spans, self.t0_ns, self.t1_ns)


def reduce(dev: List[Tuple[int, int, str]], spans: List[Tuple[int, int, str]], lo: int,
           hi: int) -> Dict[str, Any]:
    """Device intervals and host spans (start ns, end ns, name) of a traced
    stretch [lo, hi) → {"recorded", "window_s", and where the device
    recorded: "busy_s" (the union of the intervals), "device_ops" (the
    heaviest ``TOP`` by summed time), "idle_gaps" (the time the device was
    idle, by the innermost span the host was in at each gap's middle, the
    heaviest ``TOP``)}."""
    dev = [(max(s, lo), min(t, hi), name) for s, t, name in dev if min(t, hi) > max(s, lo)]
    out: Dict[str, Any] = {"window_s": (hi - lo) / 1e9, "recorded": bool(dev)}
    if not dev:
        return out
    by_op: Dict[str, float] = defaultdict(float)
    for s, t, name in dev:
        by_op[name[:120]] += (t - s) / 1e9
    merged: List[List[int]] = []
    for s, t, _ in sorted(dev):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    gaps, edge = [], lo
    for s, t in merged:
        if s > edge:
            gaps.append((edge, s))
        edge = max(edge, t)
    if hi > edge:
        gaps.append((edge, hi))
    spans = sorted(sp for sp in spans if sp[1] > lo and sp[0] < hi)
    starts = [sp[0] for sp in spans]
    by_host: Dict[str, float] = defaultdict(float)
    for g0, g1 in gaps:
        by_host[_host_span(spans, starts, (g0 + g1) // 2)] += (g1 - g0) / 1e9
    out.update(busy_s=sum(t - s for s, t in merged) / 1e9,
               device_ops=_top(by_op), idle_gaps=_top(by_host))
    return out


def _top(d: Dict[str, float]) -> List[List[Any]]:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]


def _host_span(spans: List[Tuple[int, int, str]], starts: List[int], t: int) -> str:
    """The innermost span (spans nest) that holds time t: of those begun by
    t, the latest that has not ended."""
    for i in range(bisect.bisect_right(starts, t) - 1, -1, -1):
        if spans[i][1] > t:
            return spans[i][2]
    return "outside every span"


def kernel_times(calls: Dict[str, Tuple[Callable[[], Any], float]], iters: int = 20,
                 warmup: int = 3) -> Dict[str, Dict[str, float]]:
    """Each kernel alone (``calls``: {name: (call, its least time)}),
    ``iters`` calls back to back between CUDA events after ``warmup``:
    {name: {"measured_s", "least_s"}}."""
    out = {}
    for name, (call, least_s) in calls.items():
        for _ in range(warmup):
            call()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            call()
        b.record()
        torch.cuda.synchronize()
        out[name] = {"measured_s": a.elapsed_time(b) / 1e3 / iters, "least_s": least_s}
    return out
