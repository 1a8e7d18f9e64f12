"""Workflow DAG model for the Common Workflow Scheduler.

This is the data model the CWSI transports: tasks with explicit
dependencies, data inputs (with sizes, for locality/prediction), and
resource requests. It intentionally mirrors the fields of the CWSI v1
message format from Lehmann et al. (CCGrid'23 / SC-W'23), extended with
TPU-native resource requests (chips, HBM bytes, gang size) per DESIGN.md §2.
"""
from __future__ import annotations

import itertools
import json
from collections import defaultdict, deque
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Set, Tuple


class TaskState(str, Enum):
    """Lifecycle of a task as seen through the CWSI."""

    PENDING = "PENDING"          # submitted, dependencies not met
    READY = "READY"              # dependencies met, waiting for resources
    SCHEDULED = "SCHEDULED"      # assigned to a node/slice, not yet running
    RUNNING = "RUNNING"
    SUCCEEDED = "SUCCEEDED"
    FAILED = "FAILED"            # attempt failed; may be retried
    KILLED = "KILLED"            # preempted / speculative loser
    ERROR = "ERROR"              # permanently failed (retries exhausted)
    CANCELLED = "CANCELLED"      # never ran: an ancestor failed permanently

    @property
    def terminal(self) -> bool:
        return self in (TaskState.SUCCEEDED, TaskState.ERROR,
                        TaskState.CANCELLED)

    @property
    def active(self) -> bool:
        return self in (TaskState.SCHEDULED, TaskState.RUNNING)


@dataclass(frozen=True)
class DataRef:
    """A named input/output with a size — the unit of data-aware scheduling."""

    name: str
    size_bytes: int = 0
    location: Optional[str] = None  # node/slice id currently holding it

    def to_json(self) -> Dict[str, Any]:
        return {"name": self.name, "sizeBytes": self.size_bytes, "location": self.location}

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "DataRef":
        return DataRef(d["name"], int(d.get("sizeBytes", 0)), d.get("location"))


def _checked_count(d: Dict[str, Any], key: str, default: int,
                   minimum: int) -> int:
    """Strict wire typing for the TPU count fields (chips/nodes/hbm).

    The share/quota endpoints already reject malformed numerics with a
    400; the resource counts used to silently coerce (``True`` → 1,
    ``2.5`` → 2), which turns a client bug into a quietly wrong
    placement. A count must arrive as a JSON integer (bool is a subtype
    of int in Python — rejected explicitly) at or above its floor.
    """
    v = d.get(key, default)
    if isinstance(v, bool) or not isinstance(v, int):
        raise ValueError(
            f"resources.{key} must be an integer, got {v!r}")
    if v < minimum:
        raise ValueError(
            f"resources.{key} must be >= {minimum}, got {v!r}")
    return v


@dataclass(frozen=True)
class Resources:
    """Resource request. CPU-cluster fields + TPU-native extensions."""

    cpus: float = 1.0
    mem_bytes: int = 1 << 30
    # --- TPU extensions (DESIGN.md §2): gang-scheduled slices ---
    chips: int = 0                  # 0 = plain CPU task
    hbm_bytes_per_chip: int = 0     # from compiled memory_analysis()
    accelerator: str = ""           # e.g. "tpu-v5e"
    gang: bool = False              # all-or-nothing co-scheduling
    # all-or-nothing co-placement on this many *distinct* nodes; the
    # request (cpus/mem/chips) is per node, so a nodes=k task holds
    # k × (cpus, mem, chips). k > 1 implies gang=True.
    nodes: int = 1

    def __post_init__(self) -> None:
        if self.nodes < 1:
            raise ValueError(f"resources.nodes must be >= 1, got {self.nodes!r}")
        if self.nodes > 1 and not self.gang:
            object.__setattr__(self, "gang", True)

    def to_json(self) -> Dict[str, Any]:
        out = {
            "cpus": self.cpus,
            "memoryInBytes": self.mem_bytes,
            "chips": self.chips,
            "hbmBytesPerChip": self.hbm_bytes_per_chip,
            "accelerator": self.accelerator,
            "gang": self.gang,
        }
        # emitted only when set: every pre-gang payload (and its journal
        # bytes, golden traces, recovery hashes) stays byte-identical
        if self.nodes != 1:
            out["nodes"] = self.nodes
        return out

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "Resources":
        nodes = _checked_count(d, "nodes", 1, 1)
        return Resources(
            cpus=float(d.get("cpus", 1.0)),
            mem_bytes=int(d.get("memoryInBytes", 1 << 30)),
            chips=_checked_count(d, "chips", 0, 0),
            hbm_bytes_per_chip=_checked_count(d, "hbmBytesPerChip", 0, 0),
            accelerator=d.get("accelerator", ""),
            gang=bool(d.get("gang", False)) or nodes > 1,
            nodes=nodes,
        )


@dataclass
class TaskSpec:
    """Immutable description of one task invocation (CWSI submit payload)."""

    task_id: str
    name: str                       # abstract task / process name (e.g. "fastqc")
    workflow_id: str = ""
    inputs: Tuple[DataRef, ...] = ()
    outputs: Tuple[DataRef, ...] = ()
    resources: Resources = field(default_factory=Resources)
    params: Dict[str, Any] = field(default_factory=dict)   # task-specific tool params
    # Runtime payload for the *real* executor: a callable. The simulator
    # ignores it; the wire format carries only its symbolic name.
    fn: Optional[Callable[..., Any]] = None
    base_runtime_s: float = 0.0     # ground-truth runtime at speed 1.0 (simulator only)
    max_retries: int = 3

    @property
    def input_size(self) -> int:
        return sum(r.size_bytes for r in self.inputs)

    def to_json(self) -> Dict[str, Any]:
        return {
            "id": self.task_id,
            "name": self.name,
            "workflowId": self.workflow_id,
            "inputs": [r.to_json() for r in self.inputs],
            "outputs": [r.to_json() for r in self.outputs],
            "resources": self.resources.to_json(),
            "params": self.params,
            "maxRetries": self.max_retries,
        }

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "TaskSpec":
        return TaskSpec(
            task_id=d["id"],
            name=d["name"],
            workflow_id=d.get("workflowId", ""),
            inputs=tuple(DataRef.from_json(x) for x in d.get("inputs", [])),
            outputs=tuple(DataRef.from_json(x) for x in d.get("outputs", [])),
            resources=Resources.from_json(d.get("resources", {})),
            params=dict(d.get("params", {})),
            max_retries=int(d.get("maxRetries", 3)),
        )


@dataclass
class Task:
    """Mutable runtime view of a task inside the CWS."""

    spec: TaskSpec
    state: TaskState = TaskState.PENDING
    attempt: int = 0
    node: Optional[str] = None          # assigned node / slice id
    submit_time: float = 0.0
    ready_time: float = 0.0             # when dependencies were satisfied
    schedule_time: float = 0.0
    start_time: float = 0.0
    end_time: float = 0.0
    speculative_of: Optional[str] = None  # original task id if this is a backup copy
    failure_reason: str = ""
    # id of the task's *live* launch, assigned by the engine on every
    # launch; completion reports carrying a stale id are rejected (a dead
    # launch's late success must not settle a relaunched task)
    launch_id: int = 0
    # position in the engine's ready-queue admission order (re-stamped on
    # requeue); suffixes cached priority keys so key ties resolve exactly
    # as the stable per-round sort did
    ready_seq: int = 0
    # one-shot anti-affinity veto: the node this task's previous launch
    # died on (set on requeue when the engine's retry_anti_affinity is
    # on, cleared at the next launch whether honoured or not)
    avoid_node: Optional[str] = None
    # all member nodes of the task's live gang launch (empty when the
    # task is not placed, or is a plain nodes=1 task); ``node`` is the
    # first member, kept for every single-node code path
    gang_nodes: Tuple[str, ...] = ()
    # checkpoint-committed progress in seconds of base runtime: work a
    # preempted launch does not repeat because its last checkpoint
    # manifest survives. Monotone per task; reset only by a full retry
    # after a *failure* (a crash may lose the manifest; preemption never
    # does — the engine kills only after the lease-held report settles)
    committed_s: float = 0.0

    @property
    def task_id(self) -> str:
        return self.spec.task_id

    @property
    def name(self) -> str:
        return self.spec.name

    @property
    def runtime_s(self) -> float:
        return max(0.0, self.end_time - self.start_time)


class CycleError(ValueError):
    pass


class WorkflowDAG:
    """A workflow: tasks + dependency edges, with scheduling-relevant analytics.

    The rank computations implement the priorities used by the CWS
    strategies: ``rank`` is the length (in hops, or in predicted seconds if
    weights are given) of the longest path from a task to any sink — the
    unit-weight variant of HEFT's upward rank, which is what the paper's
    "Rank" strategies use.
    """

    def __init__(self, workflow_id: str, name: str = "") -> None:
        self.workflow_id = workflow_id
        self.name = name or workflow_id
        self.tasks: Dict[str, Task] = {}
        # adjacency is insertion-ordered (dict-of-None used as an ordered
        # set): every iteration over edges must be deterministic across
        # processes, because journal replay re-derives readiness order —
        # and hence ready_seq tie-breaks — from it
        self.children: Dict[str, Dict[str, None]] = defaultdict(dict)
        self.parents: Dict[str, Dict[str, None]] = defaultdict(dict)
        self._rank_cache: Optional[Dict[str, float]] = None
        # --- incremental scheduling state ---
        # unmet dependency count: number of parents not yet SUCCEEDED
        self._unmet: Dict[str, int] = {}
        # PENDING tasks whose unmet count hit 0 but are not READY-stamped yet
        # (dict used as an insertion-ordered set)
        self._runnable: Dict[str, None] = {}
        # structure/data version, bumped on every mutation — memo key for
        # strategies caching derived quantities (e.g. HEFT weighted ranks)
        self.version: int = 0
        # tasks not yet in a terminal state (SUCCEEDED/ERROR), maintained by
        # add_task / on_task_succeeded / on_task_error so finished() is O(1)
        # on the completion hot path instead of an O(V) scan per event
        self._n_unterminated: int = 0
        # op counters (read by benchmarks/bench_sched_scale.py)
        self.readiness_ops: int = 0   # task/parent entries examined for readiness
        self.rank_ops: int = 0        # nodes visited computing/patching ranks

    # ---------------- construction ----------------
    def add_task(self, spec: TaskSpec, deps: Iterable[str] = ()) -> Task:
        if spec.task_id in self.tasks:
            raise ValueError(f"duplicate task id {spec.task_id!r}")
        deps = tuple(deps)
        # validate before inserting: a failed submit must not leave a
        # half-added task behind (it would run without its dependencies)
        for d in deps:
            if d == spec.task_id:
                raise CycleError(f"self-dependency on {d!r}")
            if d not in self.tasks:
                raise KeyError(f"unknown parent task {d!r}")
        spec.workflow_id = self.workflow_id
        task = Task(spec=spec)
        self.tasks[spec.task_id] = task
        self._unmet[spec.task_id] = 0
        self._runnable[spec.task_id] = None
        self._n_unterminated += 1
        if self._rank_cache is not None:
            # a fresh task has no children: unit rank 1
            self._rank_cache[spec.task_id] = 1.0
            self.rank_ops += 1
        for d in deps:
            self.add_dep(d, spec.task_id)
        self.version += 1
        return task

    def add_dep(self, parent: str, child: str) -> None:
        if parent not in self.tasks:
            raise KeyError(f"unknown parent task {parent!r}")
        if child not in self.tasks:
            raise KeyError(f"unknown child task {child!r}")
        if parent == child:
            raise CycleError(f"self-dependency on {parent!r}")
        if child in self.children[parent]:
            return                      # duplicate edge: idempotent
        self.children[parent][child] = None
        self.parents[child][parent] = None
        if self.tasks[parent].state != TaskState.SUCCEEDED:
            self._unmet[child] = self._unmet.get(child, 0) + 1
            if self.tasks[child].state == TaskState.PENDING:
                self._runnable.pop(child, None)
        self._patch_rank(parent, child)
        self.version += 1

    def _patch_rank(self, parent: str, child: str) -> None:
        """Patch the cached unit ranks for a new edge parent→child.

        The edge can only raise ranks of ``parent`` and its ancestors
        (rank = 1 + max over children). If relaxation ever reaches
        ``child`` again the edge closed a cycle: drop the cache and let
        ``validate()`` report it, as the full recompute would.
        """
        r = self._rank_cache
        if r is None:
            return
        if r[child] + 1.0 <= r[parent]:
            return
        r[parent] = r[child] + 1.0
        self.rank_ops += 1
        frontier = deque([parent])
        while frontier:
            node = frontier.popleft()
            for p in self.parents[node]:
                self.rank_ops += 1
                if r[node] + 1.0 > r[p]:
                    if p == child:
                        self._rank_cache = None   # cycle: defer to validate()
                        return
                    r[p] = r[node] + 1.0
                    frontier.append(p)

    # ---------------- queries ----------------
    def __len__(self) -> int:
        return len(self.tasks)

    def __contains__(self, task_id: str) -> bool:
        return task_id in self.tasks

    def task(self, task_id: str) -> Task:
        return self.tasks[task_id]

    def sources(self) -> List[str]:
        return [t for t in self.tasks if not self.parents[t]]

    def sinks(self) -> List[str]:
        return [t for t in self.tasks if not self.children[t]]

    def topological_order(self) -> List[str]:
        indeg = {t: len(self.parents[t]) for t in self.tasks}
        q = deque([t for t, d in indeg.items() if d == 0])
        order: List[str] = []
        while q:
            t = q.popleft()
            order.append(t)
            for c in self.children[t]:
                indeg[c] -= 1
                if indeg[c] == 0:
                    q.append(c)
        if len(order) != len(self.tasks):
            raise CycleError(f"workflow {self.workflow_id!r} contains a cycle")
        return order

    def validate(self) -> None:
        self.topological_order()

    def deps_satisfied(self, task_id: str) -> bool:
        self.readiness_ops += len(self.parents[task_id])
        return all(
            self.tasks[p].state == TaskState.SUCCEEDED for p in self.parents[task_id]
        )

    def ready_tasks(self, now: float = 0.0) -> List[Task]:
        """PENDING tasks whose parents all SUCCEEDED → promote to READY.

        ``now`` stamps ``ready_time`` — the FIFO key (a real SWMS submits a
        task when it becomes runnable, so queue order is readiness order).

        This is the pre-incremental full scan — O(V+E) per call. The engine
        only uses it in ``legacy_scan`` mode (benchmark baseline /
        determinism checks); the live path is ``promote_runnable`` +
        ``on_task_succeeded``.
        """
        out = []
        for tid, task in self.tasks.items():
            self.readiness_ops += 1
            if task.state == TaskState.PENDING and self.deps_satisfied(tid):
                task.state = TaskState.READY
                task.ready_time = now
                self._runnable.pop(tid, None)
            if task.state == TaskState.READY:
                out.append(task)
        return out

    # ---------------- incremental readiness ----------------
    def promote_runnable(self, now: float) -> List[Task]:
        """Stamp runnable PENDING tasks READY; return the newly promoted.

        O(newly runnable) — the counterpart of the ``ready_tasks`` full
        scan. Promotion timing matches the scan exactly: a task becomes
        runnable only when its last unmet parent succeeds (or at submit),
        both of which flag the engine's queue dirty, so the stamping
        ``now`` is the same scheduling round either way.
        """
        if not self._runnable:
            return []
        out = []
        for tid in self._runnable:
            task = self.tasks[tid]
            if task.state == TaskState.PENDING:
                task.state = TaskState.READY
                task.ready_time = now
                out.append(task)
        self._runnable.clear()
        self.readiness_ops += len(out)
        return out

    def on_task_succeeded(self, task_id: str) -> int:
        """Decrement children's unmet-dependency counts after a success.

        Returns how many children became runnable. Must be called exactly
        once per task success (success is terminal, so parents succeed at
        most once per workflow run). Also retires the task from the
        unterminated counter behind ``finished()``.
        """
        self._n_unterminated -= 1
        newly = 0
        for child in self.children[task_id]:
            self.readiness_ops += 1
            left = self._unmet.get(child, 0) - 1
            self._unmet[child] = left
            if left <= 0 and self.tasks[child].state == TaskState.PENDING:
                self._runnable[child] = None
                newly += 1
        return newly

    def on_task_error(self, task_id: str) -> None:
        """Retire a permanently failed task (retries exhausted → ERROR).

        The ERROR counterpart of ``on_task_succeeded``'s terminal
        bookkeeping; must be called exactly once per task that enters
        ERROR (ERROR is terminal, so at most once per task).
        """
        self._n_unterminated -= 1

    def cancel_descendants(self, task_id: str) -> List[str]:
        """Cancel every descendant of a permanently failed task.

        Each descendant of a non-SUCCEEDED task still holds an unmet
        dependency on it, so it is provably PENDING — CANCELLED is the
        only terminal state it can ever reach. Without this the workflow
        wedges: ``finished()`` counts the descendants as unterminated
        forever. Returns the cancelled ids in deterministic BFS
        (edge-insertion) order; must be called exactly once per task
        that enters ERROR, before ``finished()`` is consulted.
        """
        cancelled: List[str] = []
        seen: Set[str] = {task_id}
        frontier = deque([task_id])
        while frontier:
            for child in self.children[frontier.popleft()]:
                if child in seen:
                    continue
                seen.add(child)
                frontier.append(child)
                task = self.tasks[child]
                if task.state != TaskState.PENDING:
                    continue            # already cancelled via another path
                task.state = TaskState.CANCELLED
                task.failure_reason = f"ancestor {task_id!r} failed permanently"
                self._n_unterminated -= 1
                self._runnable.pop(child, None)
                cancelled.append(child)
        return cancelled

    def touch(self) -> None:
        """Bump the data version (inputs/outputs mutated in place)."""
        self.version += 1

    def state_counts(self) -> Dict[str, int]:
        """Tasks per lifecycle state (CWSI ``GET /arbiter`` status)."""
        counts: Dict[str, int] = {}
        for t in self.tasks.values():
            counts[t.state.value] = counts.get(t.state.value, 0) + 1
        return counts

    def finished(self) -> bool:
        # counter-based (O(1)): ``finished()`` sits on the completion hot
        # path — it used to be an O(V) scan run once per task completion
        return self._n_unterminated <= 0

    def succeeded(self) -> bool:
        return all(t.state == TaskState.SUCCEEDED for t in self.tasks.values())

    # ---------------- analytics ----------------
    def ranks(self, weights: Optional[Dict[str, float]] = None) -> Dict[str, float]:
        """Upward rank: longest path (in hops or weighted seconds) to a sink.

        ``weights`` maps task_id → cost; default 1.0 (unit-weight rank, as in
        the paper's Rank strategies). Result is cached for the unit case.
        """
        if weights is None and self._rank_cache is not None:
            return self._rank_cache
        w = weights or {}
        rank: Dict[str, float] = {}
        self.rank_ops += len(self.tasks)
        for tid in reversed(self.topological_order()):
            cost = w.get(tid, 1.0)
            kids = self.children[tid]
            rank[tid] = cost + (max(rank[c] for c in kids) if kids else 0.0)
        if weights is None:
            self._rank_cache = rank
        return rank

    def descendants(self, task_id: str) -> Set[str]:
        seen: Set[str] = set()
        stack = [task_id]
        while stack:
            for c in self.children[stack.pop()]:
                if c not in seen:
                    seen.add(c)
                    stack.append(c)
        return seen

    def critical_path(self, weights: Optional[Dict[str, float]] = None) -> List[str]:
        rank = self.ranks(weights)
        w = weights or {}
        cur = max(self.sources(), key=lambda t: rank[t])
        path = [cur]
        while self.children[cur]:
            cur = max(self.children[cur], key=lambda c: rank[c])
            path.append(cur)
        return path

    def makespan(self) -> float:
        done = [t for t in self.tasks.values() if t.state == TaskState.SUCCEEDED]
        if not done:
            return 0.0
        return max(t.end_time for t in done) - min(t.submit_time for t in self.tasks.values())

    def to_json(self) -> Dict[str, Any]:
        return {
            "workflowId": self.workflow_id,
            "name": self.name,
            "tasks": [t.spec.to_json() for t in self.tasks.values()],
            # insertion order, not sorted: from_json(to_json(dag)) must
            # rebuild the exact edge-insertion order the live dag had, so
            # a replayed engine promotes runnable tasks in the same order
            "edges": [
                {"from": p, "to": c}
                for p, cs in self.children.items()
                for c in cs
            ],
        }

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "WorkflowDAG":
        dag = WorkflowDAG(d["workflowId"], d.get("name", ""))
        for ts in d.get("tasks", []):
            dag.add_task(TaskSpec.from_json(ts))
        for e in d.get("edges", []):
            dag.add_dep(e["from"], e["to"])
        return dag


_task_counter = itertools.count()


def fresh_task_id(prefix: str = "task") -> str:
    return f"{prefix}-{next(_task_counter):06d}"
