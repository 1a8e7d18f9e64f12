"""The program's own spans (``repro_torch.spans``) as the metric readers
take them. A span is recorded only while a profiler records, and a run's
profiler records only over its traced stretch, which opens and closes
between rounds and steps: a run's records are the stretch's whole rounds
and steps (one run a process). A program without the module has none."""
from __future__ import annotations

from collections import defaultdict
from typing import Any, Dict, Iterator, List


class Spans:
    """The closed spans of the process, with each span's children. The
    program keeps its spans for the life of the process and nothing here
    clears them, so the readers assume one run a process, as
    ``perfbench/run.py`` makes: a second traced run in the same process
    would read the first one's spans too."""

    def __init__(self) -> None:
        try:
            from repro_torch import spans
        except ImportError:
            recs: List[Any] = []
        else:
            recs = spans.records()
        self.recs = recs
        self.kids: Dict[int, List[int]] = defaultdict(list)
        for i, r in enumerate(recs):
            if r.parent is not None:
                self.kids[r.parent].append(i)

    def named(self, name: str) -> List[int]:
        return [i for i, r in enumerate(self.recs) if r.name == name and r.end_ns is not None]

    def below(self, i: int) -> Iterator[int]:
        """Every span opened inside span i, depth first."""
        for k in self.kids[i]:
            yield k
            yield from self.below(k)

    def below_named(self, i: int, name: str) -> List[int]:
        return [k for k in self.below(i) if self.recs[k].name == name]

    def waits(self, i: int) -> List[int]:
        """The outermost spans inside span i in which the host waits on the
        card (a wait inside a wait counts once)."""
        out = []
        for k in self.kids[i]:
            if self.recs[k].wait:
                out.append(k)
            else:
                out.extend(self.waits(k))
        return out

    def host_ms(self, i: int) -> float:
        return self.recs[i].host_ms

    def device_ms(self, i: int) -> float:
        return self.recs[i].device_ms
