"""The typed command seam: every engine mutation as a closed record set.

Every state-changing operation on ``CommonWorkflowScheduler`` — node
churn from the resource manager, workflow/task submission and tenant
policy from the SWMS side of the CWSI, execution callbacks, and the
scheduling barrier itself — is expressed as one of the command records
below and routed through ``CommonWorkflowScheduler.apply(cmd, now)``:

    validate(cmd)  →  journal.append(now, cmd)  →  cmd.run(engine, now)

The set is CLOSED: these fourteen kinds are the whole mutation surface,
which is what makes the write-ahead journal (``journal.py``) a complete
account of the engine — replaying a journal reproduces the engine bit
for bit (same decision traces, same ``op_counts()``).

Two contracts every command honours:

* ``validate`` raises (``ValueError`` / ``KeyError`` /
  ``QuotaExceededError`` / ``CycleError``) for any request the engine
  would reject, and it runs BEFORE the journal append — an error
  response never reaches the log and never mutates state (the CWSI
  conformance suite pins this).
* ``to_json``/``from_json`` round-trip the command through the journal's
  JSONL wire format. Ground-truth-only fields (``TaskSpec.fn``,
  ``TaskSpec.base_runtime_s``, ``TaskResult.output``) are intentionally
  dropped: the engine never reads them, only adapters do, and a replay
  re-applies recorded outcomes instead of re-executing work. Strategies
  and arbiters journal by registry *name* — a journaled engine must be
  configured with named policies, not anonymous objects.
"""
from __future__ import annotations

import json
import math
from dataclasses import dataclass, field
from typing import Any, ClassVar, Dict, Optional, Tuple

from .arbiter import make_arbiter
from .dag import CycleError, TaskSpec, WorkflowDAG
from .strategies import Strategy, make_strategy

# compact encoder for the journal's wire fragments (no key sorting, no
# circular-reference bookkeeping — command payloads are plain trees)
_encode = json.JSONEncoder(separators=(",", ":"), ensure_ascii=False,
                           check_circular=False).encode
_dumps = json.dumps


def _qstr(s: str) -> str:
    """Quote a JSON string the cheap way when nothing needs escaping.

    Task ids are overwhelmingly plain printable text; the scan for the
    two escape triggers costs a fraction of ``json.dumps``. Non-ASCII
    stays raw (valid JSON, and ``loads``-equivalent either way)."""
    if '"' in s or "\\" in s or not s.isprintable():
        return _dumps(s)
    return f'"{s}"'


def _qbytes(s: str) -> bytes:
    """``_qstr`` for the bytes wire lines."""
    if '"' in s or "\\" in s or not s.isprintable():
        return _dumps(s).encode()
    return f'"{s}"'.encode()


_QB_CACHE: Dict[str, bytes] = {}


def _qb(s: str) -> bytes:
    """Memoized ``_qbytes`` for the per-task hot wire lines.

    Every task id is quoted at least twice per run (started + finished)
    and result reasons repeat from a tiny set; the bound keeps a
    pathological id stream from growing the map without limit."""
    v = _QB_CACHE.get(s)
    if v is None:
        if len(_QB_CACHE) >= 1 << 16:
            _QB_CACHE.clear()
        v = _QB_CACHE[s] = _qbytes(s)
    return v


class Command:
    """Base of the closed command set (see module docstring)."""

    kind: ClassVar[str] = ""
    # client-supplied exactly-once id (CWSI ``requestId``): commands the
    # server builds for a mutating route carry it, apply() marks it in
    # the engine's dedup window after the run, and it rides the journal
    # wire so replay rebuilds the window. None everywhere else.
    request_id: Optional[str] = None

    def validate(self, cws: Any) -> None:
        """Raise for a request the engine must reject.

        Runs before the command is journaled, so rejected requests never
        reach the log and never mutate the engine. The default accepts
        everything (most commands cannot fail)."""

    def run(self, cws: Any, now: float) -> Any:
        raise NotImplementedError

    def to_json(self) -> Dict[str, Any]:
        raise NotImplementedError

    def wire_args(self) -> str:
        """``to_json()`` as an already-encoded JSON fragment.

        The journal frames its entry lines itself and splices this in,
        so the per-task hot commands can override it with hand-built
        strings instead of paying the generic encoder on every append.
        Overrides must stay ``json.loads``-equivalent to ``to_json()``
        (pinned by tests/test_journal.py)."""
        return _encode(self.to_json())

    def wire_line(self, seq: int, trepr: bytes) -> bytes:
        """One complete journal entry line, ready for the appender.

        ``trepr`` is the already-encoded timestamp repr (the journal
        caches it across same-instant waves). The two per-task hot
        commands override this with a single bytes ``%`` format — one
        C-level pass that fuses framing, int formatting and the
        str->bytes encode the default pays for separately. Overrides
        must stay ``json.loads``-equivalent to the default frame
        (pinned by tests/test_journal.py)."""
        return (f'{{"seq":{seq},"t":{trepr.decode()},"cmd":"{self.kind}",'
                f'"args":{self.wire_args()}}}\n').encode()

    @staticmethod
    def from_json(args: Dict[str, Any]) -> "Command":
        raise NotImplementedError


# ---------------------------------------------------------------------------
# shared strict validators (the CWSI wire contract: no coercion, a typed
# 400 instead of silently accepting a client bug)
# ---------------------------------------------------------------------------
def checked_share(share: Any) -> float:
    if isinstance(share, bool) or not isinstance(share, (int, float)):
        raise ValueError(f"share must be a number, got {share!r}")
    share = float(share)
    if not (0.0 <= share < float("inf")):
        raise ValueError(f"share must be finite and >= 0, got {share!r}")
    return share


def checked_quota_bound(name: str, value: Any) -> Optional[int]:
    if value is None:
        return None
    if isinstance(value, bool) or not isinstance(value, int):
        raise ValueError(
            f"{name} must be a non-negative integer or null, got {value!r}")
    if value < 0:
        raise ValueError(f"{name} must be >= 0, got {value!r}")
    return value


# ---------------------------------------------------------------------------
# resource-manager side: infrastructure events
# ---------------------------------------------------------------------------
@dataclass
class AddNode(Command):
    kind: ClassVar[str] = "add_node"
    info: Any                                   # scheduler.NodeInfo

    def run(self, cws: Any, now: float) -> None:
        return cws._apply_add_node(self.info, now)

    def to_json(self) -> Dict[str, Any]:
        return {"info": self.info.to_json()}

    @staticmethod
    def from_json(args: Dict[str, Any]) -> "AddNode":
        from .scheduler import NodeInfo
        return AddNode(NodeInfo.from_json(args["info"]))


@dataclass
class RemoveNode(Command):
    kind: ClassVar[str] = "remove_node"
    name: str

    def run(self, cws: Any, now: float) -> None:
        return cws._apply_remove_node(self.name, now)

    def to_json(self) -> Dict[str, Any]:
        return {"name": self.name}

    @staticmethod
    def from_json(args: Dict[str, Any]) -> "RemoveNode":
        return RemoveNode(args["name"])


@dataclass
class SetNodeSpeed(Command):
    kind: ClassVar[str] = "set_node_speed"
    name: str
    speed_factor: float

    def run(self, cws: Any, now: float) -> None:
        return cws._apply_set_node_speed(self.name, self.speed_factor, now)

    def to_json(self) -> Dict[str, Any]:
        return {"name": self.name, "speedFactor": self.speed_factor}

    @staticmethod
    def from_json(args: Dict[str, Any]) -> "SetNodeSpeed":
        return SetNodeSpeed(args["name"], float(args["speedFactor"]))


# ---------------------------------------------------------------------------
# SWMS side: registration / submission
# ---------------------------------------------------------------------------
@dataclass
class RegisterWorkflow(Command):
    kind: ClassVar[str] = "register_workflow"
    workflow_id: str
    name: str = ""
    meta: Optional[Dict[str, Any]] = None
    request_id: Optional[str] = None

    def run(self, cws: Any, now: float) -> Any:
        return cws._apply_register_workflow(self.workflow_id, self.name,
                                            self.meta, now)

    def to_json(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"workflowId": self.workflow_id,
                             "name": self.name, "meta": self.meta}
        if self.request_id is not None:
            d["requestId"] = self.request_id
        return d

    @staticmethod
    def from_json(args: Dict[str, Any]) -> "RegisterWorkflow":
        return RegisterWorkflow(args["workflowId"], args.get("name", ""),
                                args.get("meta"), args.get("requestId"))


@dataclass
class SubmitTask(Command):
    """Submit one task (+ dependencies) to its workflow.

    ``schedule=True`` additionally requests a scheduling round, the CWSI
    ``POST .../task`` batching behaviour — part of the command so replay
    reproduces the round cadence (and ``sched_round_events``) exactly."""

    kind: ClassVar[str] = "submit_task"
    spec: TaskSpec
    deps: Tuple[str, ...] = ()
    schedule: bool = False
    request_id: Optional[str] = None

    def validate(self, cws: Any) -> None:
        # mirror of dag.add_task's checks (same exception types and
        # messages), plus the max_queued quota — anything that would make
        # run() raise must raise HERE, before the journal append
        spec, deps = self.spec, tuple(self.deps)
        dag = cws.dags.get(spec.workflow_id)
        cws._check_queued_quota(spec.workflow_id, dag, adding=1)
        tasks = dag.tasks if dag is not None else {}
        if spec.task_id in tasks:
            raise ValueError(f"duplicate task id {spec.task_id!r}")
        for d in deps:
            if d == spec.task_id:
                raise CycleError(f"self-dependency on {d!r}")
            if d not in tasks:
                raise KeyError(f"unknown parent task {d!r}")

    def run(self, cws: Any, now: float) -> Any:
        return cws._apply_submit_task(self.spec, tuple(self.deps), now,
                                      schedule=self.schedule)

    def to_json(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"task": self.spec.to_json(),
                             "dependsOn": list(self.deps),
                             "schedule": self.schedule}
        if self.request_id is not None:
            d["requestId"] = self.request_id
        return d

    @staticmethod
    def from_json(args: Dict[str, Any]) -> "SubmitTask":
        return SubmitTask(TaskSpec.from_json(args["task"]),
                          tuple(args.get("dependsOn", ())),
                          bool(args.get("schedule", False)),
                          args.get("requestId"))


@dataclass
class SubmitWorkflow(Command):
    kind: ClassVar[str] = "submit_workflow"
    dag: WorkflowDAG

    def validate(self, cws: Any) -> None:
        dag = self.dag
        dag.validate()                         # CycleError (a ValueError)
        old = cws.dags.get(dag.workflow_id)
        if old is not dag:
            cws._check_queued_quota(dag.workflow_id, None,
                                    adding=len(dag.tasks))
        if old is not None and old is not dag \
                and any(t.state.active for t in old.tasks.values()):
            raise ValueError(
                f"cannot replace workflow {dag.workflow_id!r} while "
                f"tasks are still scheduled or running")

    def run(self, cws: Any, now: float) -> None:
        return cws._apply_submit_workflow(self.dag, now)

    def to_json(self) -> Dict[str, Any]:
        return {"workflow": self.dag.to_json()}

    def wire_args(self) -> str:
        # one-shot per workflow but large: a wide DAG through the
        # generic encoder spends most of its time building the
        # intermediate per-task dicts, so spell the spec fields out and
        # fall back the moment anything looks exotic
        dag = self.dag
        try:
            # value-keyed caches: wide DAGs repeat the same (frozen,
            # hashable) Resources and the same name/workflowId strings
            # across hundreds of tasks
            rcache: Dict[Any, str] = {}
            rid: Dict[int, str] = {}      # id() front: skips the dataclass
            qcache: Dict[str, str] = {}   # hash when tasks share the object

            def q(s: str) -> str:
                out = qcache.get(s)
                if out is None:
                    out = qcache[s] = _qstr(s)
                return out

            tparts = []
            for t in dag.tasks.values():
                s, r = t.spec, t.spec.resources
                res = rid.get(id(r))
                if res is None:
                    res = rcache.get(r)
                    if res is None:
                        cpus = float(r.cpus)
                        if not math.isfinite(cpus):
                            raise ValueError("non-finite cpus")
                        # "nodes" mirrors Resources.to_json: emitted only
                        # when != 1, keeping pre-gang journal bytes stable
                        gang_sfx = (f',"nodes":{int(r.nodes)}'
                                    if r.nodes != 1 else "")
                        res = rcache[r] = (
                            f'{{"cpus":{cpus!r},'
                            f'"memoryInBytes":{int(r.mem_bytes)},'
                            f'"chips":{int(r.chips)},'
                            f'"hbmBytesPerChip":{int(r.hbm_bytes_per_chip)},'
                            f'"accelerator":{_qstr(r.accelerator)},'
                            f'"gang":{"true" if r.gang else "false"}'
                            f'{gang_sfx}}}')
                    rid[id(r)] = res
                tparts.append(
                    f'{{"id":{_qstr(s.task_id)},"name":{q(s.name)},'
                    f'"workflowId":{q(s.workflow_id)},'
                    f'"inputs":{_encode([x.to_json() for x in s.inputs]) if s.inputs else "[]"},'
                    f'"outputs":{_encode([x.to_json() for x in s.outputs]) if s.outputs else "[]"},'
                    f'"resources":{res},'
                    f'"params":{_encode(s.params) if s.params else "{}"},'
                    f'"maxRetries":{int(s.max_retries)}}}')
            edges = ",".join(f'{{"from":{q(p)},"to":{q(c)}}}'
                             for p, cs in dag.children.items() for c in cs)
            return (f'{{"workflow":{{"workflowId":{_qstr(dag.workflow_id)},'
                    f'"name":{_qstr(dag.name)},'
                    f'"tasks":[{",".join(tparts)}],"edges":[{edges}]}}}}')
        except (TypeError, ValueError):
            return _encode(self.to_json())

    @staticmethod
    def from_json(args: Dict[str, Any]) -> "SubmitWorkflow":
        return SubmitWorkflow(WorkflowDAG.from_json(args["workflow"]))


# ---------------------------------------------------------------------------
# SWMS side: tenant policy
# ---------------------------------------------------------------------------
@dataclass
class SetStrategy(Command):
    kind: ClassVar[str] = "set_strategy"
    workflow_id: str
    strategy: Any                               # registry name or Strategy
    request_id: Optional[str] = None

    def validate(self, cws: Any) -> None:
        if isinstance(self.strategy, str):
            make_strategy(self.strategy)        # ValueError for unknown names

    def run(self, cws: Any, now: float) -> Strategy:
        strat = (make_strategy(self.strategy)
                 if isinstance(self.strategy, str) else self.strategy)
        return cws._apply_set_strategy(self.workflow_id, strat)

    def to_json(self) -> Dict[str, Any]:
        name = (self.strategy if isinstance(self.strategy, str)
                else self.strategy.name)
        d: Dict[str, Any] = {"workflowId": self.workflow_id,
                             "strategy": name}
        if self.request_id is not None:
            d["requestId"] = self.request_id
        return d

    @staticmethod
    def from_json(args: Dict[str, Any]) -> "SetStrategy":
        return SetStrategy(args["workflowId"], args["strategy"],
                           args.get("requestId"))


@dataclass
class SetShare(Command):
    kind: ClassVar[str] = "set_share"
    workflow_id: str
    share: Any
    request_id: Optional[str] = None

    def validate(self, cws: Any) -> None:
        checked_share(self.share)

    def run(self, cws: Any, now: float) -> float:
        return cws._apply_set_share(self.workflow_id,
                                    checked_share(self.share), now)

    def to_json(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"workflowId": self.workflow_id,
                             "share": checked_share(self.share)}
        if self.request_id is not None:
            d["requestId"] = self.request_id
        return d

    @staticmethod
    def from_json(args: Dict[str, Any]) -> "SetShare":
        return SetShare(args["workflowId"], args["share"],
                        args.get("requestId"))


@dataclass
class SetQuota(Command):
    kind: ClassVar[str] = "set_quota"
    workflow_id: str
    max_running: Any = None
    max_queued: Any = None
    request_id: Optional[str] = None

    def validate(self, cws: Any) -> None:
        checked_quota_bound("maxRunning", self.max_running)
        checked_quota_bound("maxQueued", self.max_queued)

    def run(self, cws: Any, now: float) -> Any:
        return cws._apply_set_quota(
            self.workflow_id,
            checked_quota_bound("maxRunning", self.max_running),
            checked_quota_bound("maxQueued", self.max_queued), now)

    def to_json(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"workflowId": self.workflow_id,
                             "maxRunning": self.max_running,
                             "maxQueued": self.max_queued}
        if self.request_id is not None:
            d["requestId"] = self.request_id
        return d

    @staticmethod
    def from_json(args: Dict[str, Any]) -> "SetQuota":
        return SetQuota(args["workflowId"], args.get("maxRunning"),
                        args.get("maxQueued"), args.get("requestId"))


@dataclass
class SetArbiter(Command):
    kind: ClassVar[str] = "set_arbiter"
    arbiter: Any                                # registry name or Arbiter
    request_id: Optional[str] = None

    def validate(self, cws: Any) -> None:
        if isinstance(self.arbiter, str):
            make_arbiter(self.arbiter)          # ValueError for unknown names

    def run(self, cws: Any, now: float) -> Any:
        arb = (make_arbiter(self.arbiter)
               if isinstance(self.arbiter, str) else self.arbiter)
        return cws._apply_set_arbiter(arb)

    def to_json(self) -> Dict[str, Any]:
        name = (self.arbiter if isinstance(self.arbiter, str)
                else self.arbiter.name)
        d: Dict[str, Any] = {"arbiter": name}
        if self.request_id is not None:
            d["requestId"] = self.request_id
        return d

    @staticmethod
    def from_json(args: Dict[str, Any]) -> "SetArbiter":
        return SetArbiter(args["arbiter"], args.get("requestId"))


# ---------------------------------------------------------------------------
# execution callbacks (from the resource manager)
# ---------------------------------------------------------------------------
@dataclass
class TaskStarted(Command):
    kind: ClassVar[str] = "task_started"
    task_id: str
    launch_id: Optional[int] = None

    def run(self, cws: Any, now: float) -> None:
        return cws._apply_task_started(self.task_id, now, self.launch_id)

    def to_json(self) -> Dict[str, Any]:
        return {"taskId": self.task_id, "launchId": self.launch_id}

    def wire_args(self) -> str:
        # one of the two per-task hot commands: hand-built (~4x cheaper
        # than the generic encoder, which dominates journal overhead)
        lid = "null" if self.launch_id is None else str(self.launch_id)
        return f'{{"taskId":{_qstr(self.task_id)},"launchId":{lid}}}'

    _WIRE: ClassVar[bytes] = (
        b'{"seq":%d,"t":%b,"cmd":"task_started",'
        b'"args":{"taskId":%b,"launchId":%d}}\n')
    _WIRE_NOLID: ClassVar[bytes] = (
        b'{"seq":%d,"t":%b,"cmd":"task_started",'
        b'"args":{"taskId":%b,"launchId":null}}\n')

    def wire_line(self, seq: int, trepr: bytes) -> bytes:
        lid = self.launch_id
        if lid is None:
            return self._WIRE_NOLID % (seq, trepr, _qb(self.task_id))
        return self._WIRE % (seq, trepr, _qb(self.task_id), lid)

    @staticmethod
    def from_json(args: Dict[str, Any]) -> "TaskStarted":
        return TaskStarted(args["taskId"], args.get("launchId"))


@dataclass
class TaskFinished(Command):
    kind: ClassVar[str] = "task_finished"
    task_id: str
    result: Any                                 # scheduler.TaskResult
    launch_id: Optional[int] = None

    def run(self, cws: Any, now: float) -> None:
        return cws._apply_task_finished(self.task_id, now, self.result,
                                        self.launch_id)

    def to_json(self) -> Dict[str, Any]:
        return {"taskId": self.task_id, "result": self.result.to_json(),
                "launchId": self.launch_id}

    def wire_args(self) -> str:
        r = self.result
        cpu = float(r.cpu_seconds)
        if not math.isfinite(cpu):            # repr(inf/nan) is not JSON
            return _encode(self.to_json())
        lid = "null" if self.launch_id is None else str(self.launch_id)
        reason = "null" if r.reason is None else _qstr(r.reason)
        return (f'{{"taskId":{_qstr(self.task_id)},'
                f'"result":{{"success":{"true" if r.success else "false"},'
                f'"peakMemBytes":{int(r.peak_mem_bytes)},'
                f'"cpuSeconds":{cpu!r},'
                f'"oom":{"true" if r.oom else "false"},'
                f'"reason":{reason}}},'
                f'"launchId":{lid}}}')

    _WIRE: ClassVar[bytes] = (
        b'{"seq":%d,"t":%b,"cmd":"task_finished",'
        b'"args":{"taskId":%b,"result":{"success":%b,"peakMemBytes":%d,'
        b'"cpuSeconds":%.17g,"oom":%b,"reason":%b},"launchId":%d}}\n')
    _WIRE_NOLID: ClassVar[bytes] = (
        b'{"seq":%d,"t":%b,"cmd":"task_finished",'
        b'"args":{"taskId":%b,"result":{"success":%b,"peakMemBytes":%d,'
        b'"cpuSeconds":%.17g,"oom":%b,"reason":%b},"launchId":null}}\n')

    def wire_line(self, seq: int, trepr: bytes) -> bytes:
        # %.17g round-trips any finite double exactly (from_json re-floats
        # it), so the whole result fuses into one C-level format pass
        r = self.result
        cpu = r.cpu_seconds
        try:
            if cpu - cpu != 0:                # inf/nan: %g is not JSON
                return super().wire_line(seq, trepr)
        except TypeError:
            return super().wire_line(seq, trepr)
        head = (seq, trepr, _qb(self.task_id),
                b"true" if r.success else b"false",
                int(r.peak_mem_bytes), cpu,
                b"true" if r.oom else b"false",
                b"null" if r.reason is None else _qb(r.reason))
        lid = self.launch_id
        if lid is None:
            return self._WIRE_NOLID % head
        return self._WIRE % (head + (lid,))

    @staticmethod
    def from_json(args: Dict[str, Any]) -> "TaskFinished":
        from .scheduler import TaskResult
        return TaskFinished(args["taskId"],
                            TaskResult.from_json(args["result"]),
                            args.get("launchId"))


# ---------------------------------------------------------------------------
# the scheduling barrier
# ---------------------------------------------------------------------------
@dataclass
class ScheduleBarrier(Command):
    """Run a scheduling round.

    ``force=False`` is the ``schedule_pending`` drain: a no-op unless an
    event marked the engine pending (the engine's wrapper never journals
    the no-op case). ``force=True`` is the CWSI ``POST /schedule``
    barrier / executor poll: the round runs unconditionally."""

    kind: ClassVar[str] = "schedule_barrier"
    force: bool = False
    request_id: Optional[str] = None

    def run(self, cws: Any, now: float) -> int:
        return cws._apply_schedule_barrier(self.force, now)

    def to_json(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"force": self.force}
        if self.request_id is not None:
            d["requestId"] = self.request_id
        return d

    def wire_args(self) -> str:
        if self.request_id is not None:
            return _encode(self.to_json())
        return '{"force":true}' if self.force else '{"force":false}'

    @staticmethod
    def from_json(args: Dict[str, Any]) -> "ScheduleBarrier":
        return ScheduleBarrier(bool(args.get("force", False)),
                               args.get("requestId"))


# ---------------------------------------------------------------------------
# the report-lease sweep
# ---------------------------------------------------------------------------
@dataclass
class LeaseCheck(Command):
    """Expire overdue report leases and lift elapsed quarantines.

    Time-driven rather than request-driven, but journaled like every
    other mutation so replay reproduces the exact requeue/quarantine
    timeline. The engine's ``lease_check`` wrapper only applies it when
    a lease or quarantine is actually due, so fault-free runs journal
    nothing and stay byte-identical to before the feature existed."""

    kind: ClassVar[str] = "lease_check"

    def run(self, cws: Any, now: float) -> int:
        return cws._apply_lease_check(now)

    def to_json(self) -> Dict[str, Any]:
        return {}

    @staticmethod
    def from_json(args: Dict[str, Any]) -> "LeaseCheck":
        return LeaseCheck()


# ---------------------------------------------------------------------------
# registry: journal decode
# ---------------------------------------------------------------------------
COMMANDS: Dict[str, type] = {
    c.kind: c for c in (
        AddNode, RemoveNode, SetNodeSpeed,
        RegisterWorkflow, SubmitTask, SubmitWorkflow,
        SetStrategy, SetShare, SetQuota, SetArbiter,
        TaskStarted, TaskFinished, ScheduleBarrier, LeaseCheck,
    )
}


def decode(kind: str, args: Optional[Dict[str, Any]]) -> Command:
    """Rebuild a command from its journaled (kind, args) pair."""
    cls = COMMANDS.get(kind)
    if cls is None:
        raise ValueError(f"unknown command kind {kind!r}")
    return cls.from_json(args or {})
