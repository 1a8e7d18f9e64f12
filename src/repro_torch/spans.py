"""Spans of the program's own phases, kept in memory on the profiler's clock.

    with span("model.decode_step", key=round_no, device=dev):
        ...

While no ``torch.profiler`` session records, ``span`` returns one shared
object that does nothing: the cost is one read of PyTorch's own flag,
``torch.autograd.profiler._is_profiler_enabled``. While one records, a span
opens a ``record_function`` range of its name (so it shows beside the
kernels of any trace with CPU activity) and appends a ``Record`` to the
process's list: its name, start and end from ``time.time_ns()`` (the clock
of the profiler's events: a span's interval encloses its range's event),
the index of the span open around it, a key (a request id, a round or step
number), whether the host waits on the card in it, small integer
attributes, and, where ``device`` is a CUDA device, the card's time between
two CUDA events recorded on the current stream at its ends (on a CPU device
the host interval). Spans nest across threads: the backward's spans, run on
autograd's device thread while the caller waits inside its own span, are
that span's children. ``records()`` reads the list, ``clear()`` forgets the
closed spans. The list keeps at most ``MAX_RECORDS`` spans: past that, a
span still opens its range but is not listed (``dropped`` counts them), so a
process that profiles again and again without ``clear()`` stays bounded.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.autograd.profiler as _profiler


@dataclass
class Record:
    name: str
    start_ns: int
    end_ns: Optional[int]           # None while the span is open
    parent: Optional[int]           # index in the list of the span open around it
    key: Any
    wait: bool
    attrs: Dict[str, int]
    device_ms: Optional[float] = None   # None where the span names no device
    events: Optional[Tuple[Any, Any]] = field(default=None, repr=False)

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6


# a traced stretch of the benchmark lists a few thousand spans
MAX_RECORDS = 1 << 17

_records: List[Record] = []
_open: List[int] = []               # indices of the open spans, innermost last
_lock = threading.Lock()
dropped = 0                         # spans not listed: the list was full


class _Null:
    """What ``span`` returns while no profiler records."""
    __slots__ = ()
    recording = False

    def __enter__(self) -> "_Null":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs: int) -> None:
        pass


_NULL = _Null()


class _Span:
    __slots__ = ("rec", "depth", "range", "device")
    recording = True

    def __init__(self, name: str, key: Any, wait: bool, device: Any,
                 attrs: Dict[str, int]) -> None:
        self.rec = Record(name, 0, None, None, key, wait, attrs)
        self.device = None if device is None else torch.device(device).type
        self.range = None

    def __enter__(self) -> "_Span":
        global dropped
        rec = self.rec
        rec.start_ns = time.time_ns()
        self.range = _profiler.record_function(rec.name)
        self.range.__enter__()
        with _lock:
            self.depth = len(_open)
            if len(_records) < MAX_RECORDS:
                rec.parent = _open[-1] if _open else None
                _open.append(len(_records))
                _records.append(rec)
            else:
                dropped += 1
                self.device = None
        if self.device == "cuda":
            rec.events = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            rec.events[0].record()
        return self

    def __exit__(self, *exc) -> bool:
        rec = self.rec
        if rec.events is not None:
            rec.events[1].record()
        with _lock:
            del _open[self.depth:]
        self.range.__exit__(*exc)
        rec.end_ns = time.time_ns()
        if self.device == "cpu":
            rec.device_ms = rec.host_ms
        return False

    def set(self, **attrs: int) -> None:
        self.rec.attrs.update(attrs)


def span(name: str, *, key: Any = None, wait: bool = False, device: Any = None,
         **attrs: int):
    """A context manager: the shared no-op while no profiler records, else
    a span of ``name`` (see the module's doc). ``set(**attrs)`` on what it
    yields adds attributes known only inside the span; ``recording`` says
    whether it records, so that an attribute costly to compute is computed
    only then."""
    if not _profiler._is_profiler_enabled:
        return _NULL
    return _Span(name, key, wait, device, attrs)


def no_span(name: str, **kwargs: Any) -> _Null:
    """``span``'s signature, never a span: for a call site that opens its
    spans only on some paths (``span if ... else no_span``)."""
    return _NULL


def records() -> List[Record]:
    """Every span recorded so far, in the order they opened; the device
    times of closed spans resolved (a CUDA span waits for its end event)."""
    with _lock:
        out = list(_records)
    for rec in out:
        if rec.events is not None and rec.end_ns is not None:
            start, end = rec.events
            end.synchronize()
            rec.device_ms = start.elapsed_time(end)
            rec.events = None
    return out


def clear() -> None:
    """Forget every closed span and the count of dropped ones. Spans still
    open stay listed, first and in the order they opened, so that a span
    opened inside one of them still finds it as its parent."""
    global dropped
    with _lock:
        kept = {old: new for new, old in enumerate(_open)}
        recs = [_records[old] for old in _open]
        for rec in recs:
            rec.parent = kept.get(rec.parent)
        _records[:] = recs
        _open[:] = range(len(recs))
        dropped = 0
