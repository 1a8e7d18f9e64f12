"""Fault handling for long-running training (port of
``repro.runtime.fault``): step watchdog, elastic remesh plan, resume.

The CWS already handles *task-level* faults (requeue, OOM-doubling,
speculation). This module covers the *step-program* level:

* ``StepWatchdog`` — detects step-time stragglers inside a running job
  (the gang-scheduled analogue of the scheduler-side speculation): keeps a
  robust running estimate of step time; slow steps raise a callback that in
  production triggers slice health checks / job migration via the CWS.
* ``resume_or_init`` — the standard restart entry: restore the latest
  committed checkpoint, else init fresh. One card: ``shardings`` takes only
  ``None`` until the sharding slice.
* ``ElasticPlan`` — given old/new device counts, decides the new mesh shape
  and whether the global batch or the per-device batch is preserved.

``StepWatchdog``, ``_median`` and ``ElasticPlan`` are ``repro``'s, copied.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..checkpoint import latest_checkpoint, restore_checkpoint


class StepWatchdog:
    """Robust step-time monitor (median + MAD); flags stragglers."""

    def __init__(self, factor: float = 2.0, min_samples: int = 5,
                 on_straggler: Optional[Callable[[int, float, float], None]]
                 = None) -> None:
        self.factor = factor
        self.min_samples = min_samples
        self.on_straggler = on_straggler
        self.times: List[float] = []
        self.flagged: List[int] = []
        self._t0: Optional[float] = None
        self._step = 0

    def start(self) -> None:
        self._t0 = time.monotonic()

    def stop(self) -> bool:
        """Record one step; returns True if it was a straggler."""
        assert self._t0 is not None, "start() not called"
        dt = time.monotonic() - self._t0
        self._t0 = None
        self._step += 1
        straggler = False
        if len(self.times) >= self.min_samples:
            med = _median(self.times)
            mad = _median([abs(t - med) for t in self.times]) or med * 0.1
            if dt > self.factor * med + 3 * mad:
                straggler = True
                self.flagged.append(self._step)
                if self.on_straggler:
                    self.on_straggler(self._step, dt, med)
        # stragglers don't pollute the estimate
        if not straggler:
            self.times.append(dt)
            if len(self.times) > 100:
                self.times.pop(0)
        return straggler

    def stats(self) -> Dict[str, float]:
        if not self.times:
            return {"median_s": 0.0, "stragglers": 0}
        return {"median_s": _median(self.times),
                "stragglers": len(self.flagged)}


def _median(xs: List[float]) -> float:
    s = sorted(xs)
    n = len(s)
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


@dataclass(frozen=True)
class ElasticPlan:
    """Remesh decision when the slice pool changes size."""

    old_devices: int
    new_devices: int
    keep_global_batch: bool = True     # True → per-device batch changes

    @property
    def scale(self) -> float:
        return self.new_devices / self.old_devices

    def new_mesh_shape(self, model_parallel: int) -> Tuple[int, int]:
        """(data, model): model parallelism is topology-bound, data flexes."""
        assert self.new_devices % model_parallel == 0, (
            self.new_devices, model_parallel)
        return (self.new_devices // model_parallel, model_parallel)

    def adjust_batch(self, global_batch: int, dp_old: int, dp_new: int
                     ) -> Tuple[int, int]:
        """Returns (new_global_batch, per_device). With keep_global_batch
        the optimizer trajectory is preserved exactly (grad-accum absorbs
        the difference); otherwise throughput is preserved."""
        if self.keep_global_batch:
            assert global_batch % dp_new == 0, (global_batch, dp_new)
            return global_batch, global_batch // dp_new
        per_dev = global_batch // dp_old
        return per_dev * dp_new, per_dev


def resume_or_init(
    ckpt_dir: Optional[str],
    init_fn: Callable[[], Any],
    like: Optional[Any] = None,
    shardings: Optional[Any] = None,
    device: Optional[Any] = None,
) -> Tuple[Any, int]:
    """Restore the latest committed checkpoint or initialise fresh.

    ``like`` (default: ``init_fn()``) gives the structure, dtypes and
    device; a ``like`` on ``meta`` (``make_train_step``'s ``state_specs``)
    restores onto ``device`` (default ``cuda``) without initialising first.
    → (state, the step it holds)."""
    if ckpt_dir:
        ck = latest_checkpoint(ckpt_dir)
        if ck is not None:
            template = like if like is not None else init_fn()
            state, manifest = restore_checkpoint(ck, template, shardings,
                                                 device=device)
            return state, int(manifest["step"])
    return init_fn(), 0
