"""Central provenance store (paper §4).

The CWS sits between the workflow engine and the resource manager and is
therefore "the most suitable entity for the management of provenance data":
it sees the workflow graph (from the SWMS side) *and* the node/infrastructure
traces (from the resource-manager side). This module stores both in one
queryable place and exports a W3C-PROV-shaped JSON document.
"""
from __future__ import annotations

import json
from collections import defaultdict, deque
from dataclasses import dataclass, field, asdict
from typing import Any, Dict, Iterable, List, Optional, Tuple


@dataclass
class TaskTrace:
    """One task attempt, with workflow context and runtime metrics."""

    workflow_id: str
    task_id: str
    name: str
    attempt: int
    node: Optional[str] = None
    submit_time: float = 0.0
    schedule_time: float = 0.0
    start_time: float = 0.0
    end_time: float = 0.0
    state: str = ""
    input_size: int = 0
    output_size: int = 0
    # measured metrics (resource-manager side)
    cpu_seconds: float = 0.0
    peak_mem_bytes: int = 0
    requested_mem_bytes: int = 0
    chips: int = 0
    failure_reason: str = ""

    @property
    def runtime_s(self) -> float:
        return max(0.0, self.end_time - self.start_time)

    @property
    def queue_s(self) -> float:
        return max(0.0, self.start_time - self.submit_time)

    @property
    def mem_wastage_bytes(self) -> int:
        return max(0, self.requested_mem_bytes - self.peak_mem_bytes)


class _BoundedWindow:
    """Picklable defaultdict factory for bounded trace windows (a lambda
    closing over the retention bound would break engine snapshots)."""

    __slots__ = ("maxlen",)

    def __init__(self, maxlen: int) -> None:
        self.maxlen = maxlen

    def __call__(self) -> "deque[TaskTrace]":
        return deque(maxlen=self.maxlen)

    def __getstate__(self):
        return self.maxlen

    def __setstate__(self, state):
        self.maxlen = state


@dataclass
class NodeEvent:
    node: str
    time: float
    kind: str            # UP / DOWN / SLOW / RECOVERED / BENCH
    detail: Dict[str, Any] = field(default_factory=dict)


class ProvenanceStore:
    """In-memory (optionally file-backed) provenance store.

    Kept deliberately simple and append-only: every record is a flat dataclass
    so the store can be dumped/streamed to a real database later. This is the
    data source for the prediction plugins (paper §5) — they *only* read from
    here, never from the scheduler internals, which keeps the interface
    honest: anything a predictor uses is available over the CWSI.
    """

    def __init__(self, retention: Optional[int] = None) -> None:
        """``retention`` bounds the resident trace history: each of the
        global, per-name and per-workflow trace windows keeps at most
        that many records (oldest fall off first), so a million-task
        replay's provenance memory is launch-bound, not history-bound.
        Per-workflow summary aggregates (min submit, max successful end
        — the exact running reductions ``makespan`` used to recompute
        from the full list) are maintained regardless, so makespans stay
        exact over the whole history even after the traces behind them
        aged out. ``None`` (the default) retains everything, exactly the
        pre-retention store."""
        if retention is not None and retention <= 0:
            raise ValueError(f"retention must be positive, got {retention!r}")
        self.retention = retention
        self.task_traces: List[TaskTrace] = (
            [] if retention is None else deque(maxlen=retention))
        self.node_events: List[NodeEvent] = []
        self.workflows: Dict[str, Dict[str, Any]] = {}
        if retention is None:
            self._by_name: Dict[str, List[TaskTrace]] = defaultdict(list)
            self._by_workflow: Dict[str, List[TaskTrace]] = defaultdict(list)
        else:
            self._by_name = defaultdict(_BoundedWindow(retention))
            self._by_workflow = defaultdict(_BoundedWindow(retention))
        self.recorded_tasks = 0                  # whole-history count
        # wid -> min submit_time over every recorded trace (running min =
        # the same float ``min()`` over the full list would produce)
        self._wf_min_submit: Dict[str, float] = {}
        # wid -> max end_time over SUCCEEDED traces
        self._wf_max_end: Dict[str, float] = {}

    # ---------------- writes ----------------
    def register_workflow(self, workflow_id: str, meta: Dict[str, Any]) -> None:
        self.workflows[workflow_id] = dict(meta)

    def record_task(self, trace: TaskTrace) -> None:
        self.recorded_tasks += 1
        self.task_traces.append(trace)
        self._by_name[trace.name].append(trace)
        self._by_workflow[trace.workflow_id].append(trace)
        wid = trace.workflow_id
        cur = self._wf_min_submit.get(wid)
        if cur is None or trace.submit_time < cur:
            self._wf_min_submit[wid] = trace.submit_time
        if trace.state == "SUCCEEDED":
            cur = self._wf_max_end.get(wid)
            if cur is None or trace.end_time > cur:
                self._wf_max_end[wid] = trace.end_time

    def record_node_event(self, ev: NodeEvent) -> None:
        self.node_events.append(ev)

    # ---------------- queries (CWSI provenance endpoints) ----------------
    def traces_for_name(self, name: str, succeeded_only: bool = True) -> List[TaskTrace]:
        ts = self._by_name.get(name, ())
        if succeeded_only:
            return [t for t in ts if t.state == "SUCCEEDED"]
        return list(ts)

    def traces_for_workflow(self, workflow_id: str) -> List[TaskTrace]:
        return list(self._by_workflow.get(workflow_id, []))

    def makespan(self, workflow_id: str) -> float:
        # O(1) from the running aggregates — the same reductions
        # (max end over SUCCEEDED, min submit over all) the full-list
        # scan computed, so values are bit-identical, and they survive
        # the traces behind them aging out of a bounded window
        end = self._wf_max_end.get(workflow_id)
        if end is None:
            return 0.0
        return end - self._wf_min_submit[workflow_id]

    def total_queue_time(self, workflow_id: str) -> float:
        return sum(t.queue_s for t in self._by_workflow.get(workflow_id, []))

    def memory_wastage(self, workflow_id: Optional[str] = None) -> Tuple[int, int]:
        """Returns (wasted_byte_seconds, used_byte_seconds) — paper §5 metric."""
        ts = (
            self._by_workflow.get(workflow_id, [])
            if workflow_id
            else self.task_traces
        )
        wasted = used = 0
        for t in ts:
            if t.state != "SUCCEEDED":
                continue
            wasted += int(t.mem_wastage_bytes * t.runtime_s)
            used += int(t.peak_mem_bytes * t.runtime_s)
        return wasted, used

    def failures(self, workflow_id: Optional[str] = None) -> List[TaskTrace]:
        ts = (
            self._by_workflow.get(workflow_id, [])
            if workflow_id
            else self.task_traces
        )
        return [t for t in ts if t.state in ("FAILED", "ERROR", "KILLED")]

    def node_utilisation(self) -> Dict[str, float]:
        busy: Dict[str, float] = defaultdict(float)
        for t in self.task_traces:
            if t.node and t.state == "SUCCEEDED":
                busy[t.node] += t.runtime_s
        return dict(busy)

    # ---------------- export ----------------
    def export_prov_json(self) -> Dict[str, Any]:
        """W3C PROV-JSON-shaped export: activities=task attempts,
        agents=nodes, entities=workflows+data."""
        activities = {}
        was_associated = {}
        for i, t in enumerate(self.task_traces):
            aid = f"act:{t.task_id}:{t.attempt}"
            activities[aid] = {
                "prov:startTime": t.start_time,
                "prov:endTime": t.end_time,
                "cws:name": t.name,
                "cws:state": t.state,
                "cws:peakMem": t.peak_mem_bytes,
                "cws:cpuSeconds": t.cpu_seconds,
            }
            if t.node:
                was_associated[f"assoc:{i}"] = {
                    "prov:activity": aid,
                    "prov:agent": f"agent:{t.node}",
                }
        agents = {
            f"agent:{e.node}": {"cws:kind": "node"}
            for e in self.node_events
        }
        for t in self.task_traces:
            if t.node:
                agents.setdefault(f"agent:{t.node}", {"cws:kind": "node"})
        entities = {
            f"entity:{wid}": {"cws:kind": "workflow", **meta}
            for wid, meta in self.workflows.items()
        }
        return {
            "prefix": {"cws": "https://commonworkflowscheduler.github.io/ns#"},
            "entity": entities,
            "activity": activities,
            "agent": agents,
            "wasAssociatedWith": was_associated,
        }

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.export_prov_json(), f, indent=1)

    def summary(self) -> Dict[str, Any]:
        return {
            "workflows": len(self.workflows),
            "task_traces": len(self.task_traces),
            "recorded_tasks": self.recorded_tasks,
            "retention": self.retention,
            "node_events": len(self.node_events),
            "failures": len(self.failures()),
        }
