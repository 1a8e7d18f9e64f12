"""Discrete-event cluster simulator — the resource-manager side of the CWS.

Reproduces the paper's evaluation methodology without a physical cluster:
the CWS engine makes *exactly the same calls* it would against Kubernetes;
the simulator supplies node events, executes launches by sampling task
runtimes, and reports completions. Ground truth per task comes from the
trace generator (``base_runtime_s``, true peak memory in
``spec.params['sim']``), while the scheduler only sees requests + history —
so prediction plugins are evaluated honestly.

Faults modelled (all seeded & deterministic):
  * node crashes (running tasks requeued by the CWS) and elastic re-joins,
  * node-level slowdowns (contention → straggler mitigation kicks in),
  * per-task straggler noise (heavy-tailed runtime multiplier),
  * OOM kills when the granted allocation < true peak memory,
  * declarative chaos plans (``faults.FaultPlan``): correlated
    failure-domain outages, node flap, injected transient/permanent task
    failures, and silently lost start/finish reports — the launch-level
    faults arrive through ``fault_injector`` (set by
    ``FaultInjector.arm``) from the plan's own seeded generator, so the
    simulator's random stream is untouched and a run without a plan is
    bit-identical to before the hook existed.
"""
from __future__ import annotations

import heapq
import itertools
import math
import warnings
from bisect import insort
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from ..core import commands as _cmd
from ..core.dag import Task, TaskState, WorkflowDAG
from ..core.scheduler import CommonWorkflowScheduler, NodeInfo, TaskResult

# Events are plain tuples ``(time, seq, kind, payload)``: the seq is
# globally unique, so tuple comparison decides on (time, seq) and never
# reaches the unorderable payload — and C-speed tuple compares are what
# both queue implementations sort by, keeping the (time, seq) total
# order identical between them.
_Event = Tuple[float, int, str, Dict[str, Any]]


class _EventHeap:
    """Baseline binary-heap event queue (the pre-wheel implementation,
    kept for the wheel's bit-identity oracle and benchmarking)."""

    __slots__ = ("_heap",)

    def __init__(self) -> None:
        self._heap: List[_Event] = []

    def __len__(self) -> int:
        return len(self._heap)

    def push(self, ev: _Event) -> None:
        heapq.heappush(self._heap, ev)

    def pop(self) -> _Event:
        return heapq.heappop(self._heap)

    def peek_time(self) -> Optional[float]:
        return self._heap[0][0] if self._heap else None


class _TimeWheel:
    """Calendar-queue event queue (Brown '88): amortized O(1) push/pop.

    Events hash into width-``w`` time slots, slot → bucket modulo a
    power-of-two bucket count; each bucket is kept sorted. A cursor walks
    slots in increasing order, popping a bucket's head while the head
    belongs to the cursor's slot, so a pop costs O(1) plus the rotation
    to the next occupied slot. The bucket count tracks the resident
    population (grow at 2x occupancy, shrink below 1/2x, width
    re-estimated as queued-span / population) so rotations stay short;
    a fruitless full rotation (population clustered far ahead of the
    cursor) falls back to a direct min scan that teleports the cursor.

    Bit-identity with the heap: pops follow the event tuples' own
    (time, seq) order. Slot membership uses the SAME ``int(t / w)`` on
    the push and pop sides, so float rounding can never disagree about
    an event's slot; the cursor is always <= the global minimum's slot
    (pops restore it, pushes clamp it), and slot number is monotone in
    time, so the increasing-slot walk always surfaces the minimum first.
    The one-event head lookahead keeps ``peek_time`` O(1) for the
    driver's after-every-event batch-boundary check.
    """

    __slots__ = ("_buckets", "_mask", "_width", "_cursor", "_size", "_head")

    _MIN_BUCKETS = 8
    _MAX_BUCKETS = 1 << 20

    def __init__(self) -> None:
        self._buckets: List[List[_Event]] = [
            [] for _ in range(self._MIN_BUCKETS)]
        self._mask = self._MIN_BUCKETS - 1
        self._width = 1.0
        self._cursor = 0              # slot number (NOT bucket index)
        self._size = 0                # events resident in buckets
        self._head: Optional[_Event] = None   # global minimum, out-of-bucket

    def __len__(self) -> int:
        return self._size + (self._head is not None)

    def peek_time(self) -> Optional[float]:
        return self._head[0] if self._head is not None else None

    def push(self, ev: _Event) -> None:
        head = self._head
        if head is None:
            self._head = ev
            return
        if ev < head:                 # new global min: swap into the head
            self._head = ev
            ev = head
        slot = int(ev[0] / self._width)
        if slot < self._cursor:
            self._cursor = slot
        insort(self._buckets[slot & self._mask], ev)
        self._size += 1
        if self._size > 2 * (self._mask + 1) \
                and self._mask + 1 < self._MAX_BUCKETS:
            self._resize()

    def pop(self) -> _Event:
        ev = self._head
        if ev is None:
            raise IndexError("pop from an empty time wheel")
        self._head = self._take_min() if self._size else None
        return ev

    def _take_min(self) -> _Event:
        width = self._width
        mask = self._mask
        buckets = self._buckets
        slot = self._cursor
        for _ in range(mask + 1):
            b = buckets[slot & mask]
            if b and int(b[0][0] / width) <= slot:
                self._cursor = slot
                ev = b.pop(0)
                break
            slot += 1
        else:
            # fruitless full rotation: the minimum lives more than one
            # wheel revolution ahead — take it directly (each bucket's
            # head is its min) and teleport the cursor to its slot
            best: Optional[_Event] = None
            best_b: Optional[List[_Event]] = None
            for b in buckets:
                if b and (best is None or b[0] < best):
                    best = b[0]
                    best_b = b
            assert best_b is not None
            ev = best_b.pop(0)
            self._cursor = int(ev[0] / width)
        self._size -= 1
        n = mask + 1
        if n > self._MIN_BUCKETS and self._size < n // 2:
            self._resize()
        return ev

    def _resize(self) -> None:
        events: List[_Event] = []
        for b in self._buckets:
            events.extend(b)
        n = self._MIN_BUCKETS
        while n < len(events):
            n <<= 1
        n = min(n, self._MAX_BUCKETS)
        if events:
            tmin = min(ev[0] for ev in events)
            tmax = max(ev[0] for ev in events)
            span = tmax - tmin
            if span > 0.0:
                # width ~ mean gap: one resident event per slot on
                # average, so rotations advance ~1 slot per pop
                self._width = span / len(events)
            self._cursor = int(tmin / self._width)
        self._buckets = [[] for _ in range(n)]
        self._mask = n - 1
        width = self._width
        mask = self._mask
        for ev in events:
            insort(self._buckets[int(ev[0] / width) & mask], ev)


_EVENT_QUEUES = {"wheel": _TimeWheel, "heap": _EventHeap}

# externally injected (finite-by-construction) event kinds: their
# firing is progress for the stall-based livelock guard in ``run``
_PROGRESS_KINDS = frozenset(
    {"WF_SUBMIT", "CALL", "NODE_FAIL", "NODE_JOIN", "NODE_SLOW"})


@dataclass
class SimConfig:
    seed: int = 0
    runtime_noise_sigma: float = 0.08      # lognormal sigma on every task
    straggler_prob: float = 0.0            # per-task heavy-tail probability
    straggler_factor: Tuple[float, float] = (2.0, 5.0)
    staging_bandwidth: float = 1e9         # bytes/s for non-local inputs
    staging_latency: float = 0.5           # container/pod start overhead (s)
    oom_check: bool = True
    speculation_period: float = 15.0       # how often to scan for stragglers
    event_queue: str = "wheel"             # "wheel" | "heap" (bit-identical)


class ClusterSimulator:
    """Implements the ``ClusterAdapter`` protocol against virtual time."""

    def __init__(self, nodes: List[NodeInfo], config: Optional[SimConfig] = None):
        self.config = config or SimConfig()
        self.rng = np.random.default_rng(self.config.seed)
        self.now = 0.0
        try:
            self._queue = _EVENT_QUEUES[self.config.event_queue]()
        except KeyError:
            raise ValueError(
                f"unknown event_queue {self.config.event_queue!r} "
                f"(choose from {sorted(_EVENT_QUEUES)})") from None
        self._seq = itertools.count()
        # deferred-round bookkeeping (engine decision_lag > 0): the one
        # outstanding ROUND wakeup's instant, plus counters the tests and
        # bench read — lag 0 must never defer (the tripwire)
        self._round_wakeup: Optional[float] = None
        self.round_deferrals = 0
        self.round_wakeups = 0
        self.events_processed = 0     # lifetime, across run() calls
        self._initial_nodes = list(nodes)
        self.cws: Optional[CommonWorkflowScheduler] = None
        # launch bookkeeping: task_id -> live launch generation
        self._launch_gen: Dict[str, int] = {}
        self._gen = itertools.count(1)
        self._node_of_launch: Dict[int, str] = {}
        self._task_of_launch: Dict[int, Task] = {}
        # node -> unretired launch generations; NODE_FAIL consults only
        # this (not every launch in history)
        self._gens_on_node: Dict[str, set] = {}
        # gang launches only: gen -> every member node, so _retire can
        # deregister the generation from all of them (singles stay on
        # the _node_of_launch fast path)
        self._members_of_launch: Dict[int, Tuple[str, ...]] = {}
        self.launches = 0
        self.kills = 0
        # per-launch fault oracle (faults.FaultInjector.arm installs it);
        # None means every launch runs and reports cleanly
        self.fault_injector: Optional[Any] = None

    # ------------------------------------------------------------------
    def attach(self, cws: CommonWorkflowScheduler) -> None:
        self.cws = cws
        cws.staging_bandwidth = self.config.staging_bandwidth
        # every resource-manager event enters the engine as a command
        # through the apply seam, so an attached journal records exactly
        # this simulator's history (replay-identical by construction)
        for n in self._initial_nodes:
            cws.apply(_cmd.AddNode(n), self.now)
        if cws.enable_speculation:
            self._push(self.now + self.config.speculation_period, "SPEC_CHECK", {})
        if cws.report_lease is not None:
            self._push(self.now + cws.report_lease, "LEASE_CHECK", {})

    # ---- ClusterAdapter protocol ----
    def launch(self, task: Task, node: str, mem_alloc: int) -> None:
        assert self.cws is not None
        gen = next(self._gen)
        self._launch_gen[task.task_id] = gen
        self._node_of_launch[gen] = node
        self._task_of_launch[gen] = task
        self._gens_on_node.setdefault(node, set()).add(gen)
        members = task.gang_nodes if len(task.gang_nodes) > 1 else (node,)
        if len(members) > 1:
            # gang: the generation is live on every member, so losing ANY
            # member node kills the whole launch (all-or-nothing execution
            # mirrors all-or-nothing placement)
            self._members_of_launch[gen] = tuple(members)
            for m in members:
                if m != node:
                    self._gens_on_node.setdefault(m, set()).add(gen)
        # engine-issued launch id, reported back with start/finish so the
        # engine itself can reject reports from superseded launches
        lid = task.launch_id
        self.launches += 1

        sim = task.spec.params.get("sim", {})
        true_peak = int(sim.get("peak_mem", 0))
        # ground-truth runtime: direct submissions carry base_runtime_s;
        # tasks that crossed the CWSI wire carry it in params["sim"]
        # (the wire format intentionally omits ground truth fields)
        base_runtime = task.spec.base_runtime_s or float(sim.get("runtime", 0.0))
        # staging: move non-resident inputs, plus constant startup latency
        remote = sum(r.size_bytes for r in task.spec.inputs
                     if r.location is not None and r.location != node)
        stage = self.config.staging_latency + remote / self.config.staging_bandwidth
        start = self.now + stage

        if task.committed_s > 0.0:
            # resume from the last committed checkpoint: only the
            # remaining base-runtime work is executed on this launch
            base_runtime = max(base_runtime - task.committed_s, 0.0)

        speed = self.cws.nodes[node].info.speed_factor if node in self.cws.nodes else 1.0
        if len(members) > 1:
            # a gang paces at its slowest member (synchronous steps)
            speed = min(
                (self.cws.nodes[m].info.speed_factor
                 for m in members if m in self.cws.nodes),
                default=speed)
        noise = float(self.rng.lognormal(0.0, self.config.runtime_noise_sigma))
        straggle = 1.0
        if self.config.straggler_prob > 0 and self.rng.random() < self.config.straggler_prob:
            lo, hi = self.config.straggler_factor
            straggle = float(self.rng.uniform(lo, hi))
        runtime = base_runtime / max(speed, 1e-6) * noise * straggle
        req_nodes = task.spec.resources.nodes
        if req_nodes > 1 and len(members) < req_nodes:
            # elastic resize: fewer data-parallel replicas → proportionally
            # more wall-clock per step
            runtime *= req_nodes / len(members)

        if self.config.oom_check and true_peak > 0 and mem_alloc < true_peak:
            # OOM-kill partway through (the task dies when it touches the
            # allocation boundary — model at the matching fraction of runtime)
            frac = max(0.05, min(1.0, mem_alloc / true_peak))
            self._push(start, "TASK_START", {"gen": gen, "lid": lid})
            self._push(start + runtime * frac, "TASK_FINISH", {
                "gen": gen, "lid": lid,
                "result": TaskResult(False, peak_mem_bytes=mem_alloc, oom=True,
                                     reason="OOMKilled"),
            })
            return

        if self.fault_injector is not None:
            v = self.fault_injector.launch_faults(task)
            if v.fail:
                # injected failure, reported like any real one: the task
                # dies partway through and the engine spends a retry
                self._push(start, "TASK_START", {"gen": gen, "lid": lid})
                self._push(start + runtime * v.fail_frac, "TASK_FINISH", {
                    "gen": gen, "lid": lid,
                    "result": TaskResult(False, peak_mem_bytes=mem_alloc // 2,
                                         reason=v.reason),
                })
                return
            if v.drop_start:
                # silent loss at launch: neither report ever arrives, the
                # generation stays live until a report lease reclaims it
                return
            if v.drop_finish:
                # death mid-run: the start lands, then silence
                self._push(start, "TASK_START", {"gen": gen, "lid": lid})
                return

        cpu_eff = float(sim.get("cpu_utilisation", 0.8))
        self._push(start, "TASK_START", {"gen": gen, "lid": lid})
        self._push(start + runtime, "TASK_FINISH", {
            "gen": gen, "lid": lid,
            "result": TaskResult(
                True,
                peak_mem_bytes=true_peak or mem_alloc // 2,
                cpu_seconds=runtime * task.spec.resources.cpus * cpu_eff,
            ),
        })

    def kill(self, task_id: str) -> None:
        gen = self._launch_gen.pop(task_id, None)   # invalidate in-flight events
        if gen is not None:
            self._retire(gen)
        self.kills += 1

    def _retire(self, gen: int) -> None:
        """Drop a launch's bookkeeping once it can never go live again."""
        node = self._node_of_launch.pop(gen, None)
        self._task_of_launch.pop(gen, None)
        members = self._members_of_launch.pop(gen, None)
        for m in (members if members is not None else
                  ((node,) if node is not None else ())):
            gens = self._gens_on_node.get(m)
            if gens is not None:
                gens.discard(gen)
                if not gens:
                    del self._gens_on_node[m]

    # ------------------------------------------------------------------
    # fault & elasticity injection (schedule before run())
    # ------------------------------------------------------------------
    def fail_node_at(self, time: float, node: str) -> None:
        self._push(time, "NODE_FAIL", {"node": node})

    def join_node_at(self, time: float, info: NodeInfo) -> None:
        self._push(time, "NODE_JOIN", {"info": info})

    def slow_node_at(self, time: float, node: str, speed_factor: float) -> None:
        self._push(time, "NODE_SLOW", {"node": node, "speed": speed_factor})

    def submit_workflow_at(self, time: float, dag: WorkflowDAG) -> None:
        self._push(time, "WF_SUBMIT", {"dag": dag})

    def call_at(self, time: float, fn: Callable[[float], None]) -> None:
        """Run ``fn(now)`` at a virtual instant (before that instant's
        coalesced scheduling round). The hook for mid-run tenant-policy
        changes — e.g. a CWSI ``PUT .../share`` flip driving preemptive
        arbitration — without teaching the event loop new verbs."""
        self._push(time, "CALL", {"fn": fn})

    # ------------------------------------------------------------------
    def _push(self, time: float, kind: str, payload: Dict[str, Any]) -> None:
        self._queue.push((time, next(self._seq), kind, payload))

    def _live(self, gen: int) -> Optional[Task]:
        task = self._task_of_launch.get(gen)
        if task is None:
            return None
        if self._launch_gen.get(task.task_id) != gen:
            return None   # superseded (retried/killed) launch
        return task

    def run(self, until: float = math.inf,
            max_events: Optional[int] = None,
            stall_events: int = 1_000_000) -> float:
        """Drain the event loop; returns the final virtual time.

        Scheduling rounds are coalesced: event handlers only mark the
        engine pending (``request_schedule``), and one round runs per
        *virtual timestamp* once every same-time event has been applied —
        a W-wide same-timestamp completion burst costs one round, not W.
        An engine with ``decision_lag > 0`` stretches the window across
        timestamps: the pending round is deferred until its deadline
        (first request + lag), absorbing every event in between; a ROUND
        wakeup guarantees the deadline is reached even when the queue
        holds nothing before it. With ``sync_schedule=True`` engines the
        handlers schedule inline and ``schedule_pending`` is a no-op,
        restoring the old cadence.

        Liveness is guarded by *stall* accounting, not an absolute event
        budget (the old hard ``max_events=10_000_000`` counted benign
        SPEC_CHECK wakeups and task events alike, aborting legitimate
        million-task replays): progress is a task settling for good
        (``cws.tasks_settled`` — SUCCEEDED or terminal ERROR) or an
        externally injected, finite-by-construction event (submission,
        node churn, ``call_at`` hook); the run aborts once
        ``stall_events`` events pass without either. A clean replay
        settles a task every few events regardless of workload size,
        while a genuine requeue livelock — launch/kill churn with
        nothing ever settling — still trips the guard. Pass
        ``max_events`` for the old absolute cap on top.
        """
        assert self.cws is not None, "attach() a scheduler first"
        cws = self.cws
        # work deferred before run() (e.g. CWSI batch submits) starts now
        cws.schedule_pending(self.now)
        queue = self._queue
        n = 0
        stall = 0
        settled = cws.tasks_settled
        while queue and queue.peek_time() <= until:
            n += 1
            if max_events is not None and n > max_events:
                raise RuntimeError("simulator event budget exceeded (livelock?)")
            _, _, kind, payload = ev = queue.pop()
            self.now = ev[0]

            if kind == "TASK_START":
                task = self._live(payload["gen"])
                if task is not None:
                    cws.apply(_cmd.TaskStarted(
                        task.task_id, launch_id=payload.get("lid")),
                        self.now)

            elif kind == "TASK_FINISH":
                gen = payload["gen"]
                task = self._live(gen)
                if task is not None:
                    self._launch_gen.pop(task.task_id, None)
                    cws.apply(_cmd.TaskFinished(
                        task.task_id, payload["result"],
                        launch_id=payload.get("lid")), self.now)
                self._retire(gen)

            elif kind == "NODE_FAIL":
                node = payload["node"]
                # drop in-flight events of launches on that node (only the
                # node's unretired generations — not every launch ever made)
                for gen in list(self._gens_on_node.get(node, ())):
                    task = self._task_of_launch.get(gen)
                    if task is not None \
                            and self._launch_gen.get(task.task_id) == gen:
                        self._launch_gen.pop(task.task_id, None)
                    self._retire(gen)
                cws.apply(_cmd.RemoveNode(node), self.now)

            elif kind == "NODE_JOIN":
                cws.apply(_cmd.AddNode(payload["info"]), self.now)

            elif kind == "NODE_SLOW":
                cws.apply(_cmd.SetNodeSpeed(payload["node"],
                                            payload["speed"]), self.now)

            elif kind == "WF_SUBMIT":
                cws.apply(_cmd.SubmitWorkflow(payload["dag"]), self.now)

            elif kind == "CALL":
                payload["fn"](self.now)

            elif kind == "ROUND":
                # bare wakeup for a deferred round: the flush below sees
                # the deadline reached. A stale wakeup (its round already
                # ran earlier, pulled in by an intervening event batch)
                # drains as a harmless no-op.
                pass

            elif kind == "SPEC_CHECK":
                # only a round that can change anything: a speculative
                # launch consumed resources (capacity/ready changes from
                # other events already request their own rounds — an
                # unconditional request here ran one empty round per
                # wakeup for the whole run)
                if cws.check_speculation(self.now):
                    cws.request_schedule(self.now)
                # O(1) re-arm: the engine maintains its unfinished-
                # workflow set at the state transitions — the old
                # ``any(not d.finished() for d in cws.dags.values())``
                # scan here cost O(live workflows) per periodic wakeup
                if cws.has_unfinished_work():
                    self._push(self.now + self.config.speculation_period,
                               "SPEC_CHECK", {})

            elif kind == "LEASE_CHECK":
                # the engine journals a LeaseCheck command only when a
                # lease or quarantine is actually due, so the periodic
                # wakeup is journal-silent on clean runs
                cws.lease_check(self.now)
                if cws.has_unfinished_work() or len(queue) > 0:
                    self._push(self.now + cws.report_lease,
                               "LEASE_CHECK", {})

            if cws.tasks_settled != settled or kind in _PROGRESS_KINDS:
                settled = cws.tasks_settled
                stall = 0
            else:
                stall += 1
                if stall > stall_events:
                    raise RuntimeError(
                        f"simulator stalled: {stall} events without a "
                        f"task settling or external input (livelock?)")

            # same-timestamp batch drained (launches may re-arm the current
            # timestamp; the loop then drains and flushes it again) → run
            # the single coalesced round for this instant, or defer it to
            # its micro-batching deadline
            nt = queue.peek_time()
            if (nt is None or nt > self.now) and cws._sched_pending:
                deadline = cws._sched_deadline
                if deadline <= self.now:      # decision_lag 0 always lands here
                    cws.schedule_pending(self.now)
                    self._round_wakeup = None
                else:
                    self.round_deferrals += 1
                    if (nt is None or nt > deadline) \
                            and self._round_wakeup != deadline:
                        self._round_wakeup = deadline
                        self.round_wakeups += 1
                        self._push(deadline, "ROUND", {})
        # a round requested by the final batch (or by an `until` cutoff)
        # still runs at the last processed instant
        cws.schedule_pending(self.now)
        self.events_processed += n
        return self.now


def run_workflow(
    dag: WorkflowDAG,
    nodes: List[NodeInfo],
    strategy: str = "rank_min_rr",
    sim_config: Optional[SimConfig] = None,
    **cws_kwargs: Any,
) -> Tuple[float, CommonWorkflowScheduler]:
    """Convenience: simulate one workflow to completion, return (makespan, cws)."""
    makespans, cws = run_workflows([dag], nodes, strategy, sim_config,
                                   **cws_kwargs)
    return makespans[dag.workflow_id], cws


def run_workflows(
    dags: List[WorkflowDAG],
    nodes: List[NodeInfo],
    strategy: str = "rank_min_rr",
    sim_config: Optional[SimConfig] = None,
    submit_times: Optional[List[float]] = None,
    shares: Optional[Dict[str, float]] = None,
    arbiter: str = "first_appearance",
    **cws_kwargs: Any,
) -> Tuple[Dict[str, float], CommonWorkflowScheduler]:
    """Multi-tenant convenience: run concurrent workflows under an arbiter.

    ``shares`` maps workflow_id → fair-share weight / strict priority
    (set before any submission, as a tenant would over the CWSI); returns
    per-workflow makespans keyed by workflow_id plus the scheduler.
    """
    if shares and arbiter == "first_appearance":
        # shares are harmless tenant policy (the CWSI accepts them any
        # time), but under this arbiter they do nothing — surface the
        # no-op instead of raising so arbiter-comparison sweeps can reuse
        # one tenant config
        warnings.warn(
            "shares have no effect under the first_appearance arbiter; "
            "pass arbiter='fair_share' or 'strict_priority' to use them",
            stacklevel=2)
    sim = ClusterSimulator(nodes, sim_config)
    cws = CommonWorkflowScheduler(adapter=sim, strategy=strategy,
                                  arbiter=arbiter, **cws_kwargs)
    for wid, share in (shares or {}).items():
        cws.set_workflow_share(wid, share)
    sim.attach(cws)
    times = submit_times if submit_times is not None else [0.0] * len(dags)
    if len(times) != len(dags):
        raise ValueError(
            f"submit_times has {len(times)} entries for {len(dags)} workflows")
    for dag, t in zip(dags, times):
        sim.submit_workflow_at(t, dag)
    sim.run()
    unfinished = [d for d in dags if not d.finished()]
    if unfinished:
        raise RuntimeError("workflows did not finish: " + ", ".join(
            f"{d.workflow_id} "
            f"({sum(t.state.terminal for t in d.tasks.values())}/{len(d)})"
            for d in unfinished))
    return (
        {d.workflow_id: cws.provenance.makespan(d.workflow_id) for d in dags},
        cws,
    )
