"""The Common Workflow Scheduler (CWS) engine.

The CWS runs *inside* the resource manager (paper Fig. 1): the resource
manager delivers node/infrastructure events and executes launch/kill commands
through a small ``ClusterAdapter`` protocol; workflow engines talk to the CWS
exclusively through the CWSI (``cwsi.py``). The engine owns:

  * task state machines + retries (with memory-doubling on OOM, §5),
  * resource accounting (cpus / memory / TPU chips; gang = all-or-nothing),
  * the pluggable ``Strategy`` (ordering + placement),
  * online feeding of the prediction plugins and the provenance store,
  * straggler mitigation by speculative execution (first finisher wins),
  * elastic node join/leave (running work on a lost node is requeued),
  * preemptive arbitration (``max_preemptions_per_round > 0``): share
    changes at runtime may kill-and-requeue over-share launches, with the
    lost work charged to the victim's deficit accounting so fair share
    converges; per-tenant queue quotas (``max_running`` at emission,
    ``max_queued`` at submission) bound what any one tenant can hold,
  * a registration TTL that reaps workflows registered but never given
    tasks (completion-driven retirement cannot see them), and the same
    TTL for shares/quotas declared for workflow ids that never register,
  * the command seam (``commands.py``): every mutation above enters
    through ``apply(cmd, now)`` — validate, write-ahead journal
    (``journal.py``, optional), then run — so a journal replay rebuilds
    the engine bit-identically (the public mutator methods are thin
    wrappers constructing the corresponding command).

The event→decision path is amortized constant time: events mark the
scheduler pending (``request_schedule``) and the driver coalesces every
same-timestamp event into one round (``schedule_pending``); arbiter
accounting (cluster totals, per-workflow dominant-resource usage) is
maintained as launch/release deltas; and ``dag.finished()`` is a
counter, not a scan. The *placement* path is sublinear in cluster size:
a node-capacity index (``node_index.py``) answers the feasibility
watermark, the per-round memory cap, and every ``place_key``-declaring
strategy's placement in O(log N), node views are materialised lazily
(only for oracle placements) and patched per launch, and finished
workflows retire to bounded tombstones so memory tracks live work.
``sync_schedule=True`` restores the round-per-event cadence and
``legacy_scan=True`` the per-round rescan + full-scan-placement cost
model, for baselines.
The incremental *cost model* never changes decisions (usage floats,
cached orders, and patched views are bit-identical — pinned by
tests/golden and the bench). Coalescing itself is decision-identical
whenever same-instant events do not compete for scarce slots — whole-DAG
submission stays a synchronous barrier, and the golden/bench workloads
are pinned bit-identical — but a coalesced round *sees the union ready
set of its instant*: when same-instant completions race for the last
slots, it orders them with full information where the sync cadence
served them event-by-event.

In the TPU adaptation a "node" is a *slice* (e.g. one pod = 256 chips). A
step-program that fits one slice is a plain task; a cross-slice program
demands ``Resources.nodes = k`` and is placed as a **gang**: all-or-nothing
co-placement on k distinct nodes, one launch id, one allocation record
spanning k node states (``_Allocation.members``), released and requeued as
a unit — partial placement can never leak, because member bookkeeping is
only written after the k-node fit query succeeded. Arbiter dominant-share
accounting, quotas, report leases and quarantine all count a gang as ONE
task over k nodes' resources. Preemption is checkpoint-aware: a preempted
gang carries ``Task.committed_s`` forward from its checkpoint cadence
(``params["ckpt"]["interval_s"]``), requeues with remaining-work debt, and
may resize to fewer nodes under pressure through the elastic width ladder
(``params["elastic"]["allowed"]`` — validated SWMS-side against
``ElasticPlan.new_mesh_shape``). ``nodes == 1`` (the default) never enters
any gang path, so the single-node engine is bit-identical to before.
"""
from __future__ import annotations

import logging
import math
from dataclasses import dataclass, field, replace
from typing import Any, Callable, Dict, List, Optional, Protocol, Tuple

from . import commands as _cmd
from .arbiter import (
    Arbiter,
    ArbiterContext,
    PreemptionCandidate,
    WorkflowQuota,
    deficits as _share_deficits,
    dominant_cost,
    make_arbiter,
)
from .dag import DataRef, Task, TaskSpec, TaskState, WorkflowDAG, fresh_task_id
from .node_index import NodeCapacityIndex, fits_demand as _fits_demand
from .predict import FeedbackMemoryPredictor, LotaruPredictor, NodeProfile
from .provenance import NodeEvent, ProvenanceStore, TaskTrace
from .strategies import (
    NodeView,
    PlacementKey,
    SchedulingContext,
    Strategy,
    make_strategy,
)

log = logging.getLogger("repro.cws")


class _Seq:
    """A picklable monotonic counter (`itertools.count` cannot pickle,
    and journal snapshots pickle the whole engine — the ready/launch
    sequences ARE decision state, so they must survive recovery)."""

    __slots__ = ("n",)

    def __init__(self, start: int = 1) -> None:
        self.n = start

    def __next__(self) -> int:
        n = self.n
        self.n = n + 1
        return n

    def __getstate__(self):
        return self.n

    def __setstate__(self, n):
        self.n = n


@dataclass
class NodeInfo:
    """Static description of a node/slice as registered by the resource manager."""

    name: str
    cpus: float = 8.0
    mem_bytes: int = 32 << 30
    chips: int = 0
    hbm_bytes_per_chip: int = 16 << 30
    speed_factor: float = 1.0
    labels: Dict[str, str] = field(default_factory=dict)

    def to_json(self) -> Dict[str, Any]:
        return {
            "name": self.name, "cpus": self.cpus,
            "memBytes": self.mem_bytes, "chips": self.chips,
            "hbmBytesPerChip": self.hbm_bytes_per_chip,
            "speedFactor": self.speed_factor, "labels": dict(self.labels),
        }

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "NodeInfo":
        return NodeInfo(
            name=d["name"], cpus=float(d.get("cpus", 8.0)),
            mem_bytes=int(d.get("memBytes", 32 << 30)),
            chips=int(d.get("chips", 0)),
            hbm_bytes_per_chip=int(d.get("hbmBytesPerChip", 16 << 30)),
            speed_factor=float(d.get("speedFactor", 1.0)),
            labels=dict(d.get("labels") or {}),
        )


@dataclass
class TaskResult:
    """Completion report delivered by the resource manager."""

    success: bool
    peak_mem_bytes: int = 0
    cpu_seconds: float = 0.0
    oom: bool = False
    reason: str = ""
    output: Any = None

    # ``output`` is deliberately NOT journaled: the engine never reads it
    # (only ``Executor.run_to_completion`` hands it back to the client),
    # and a recovered engine re-credits completions, it does not re-run
    # them — so the wire form carries exactly what decisions depend on.
    def to_json(self) -> Dict[str, Any]:
        return {
            "success": self.success, "peakMemBytes": self.peak_mem_bytes,
            "cpuSeconds": self.cpu_seconds, "oom": self.oom,
            "reason": self.reason,
        }

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "TaskResult":
        return TaskResult(
            success=bool(d["success"]),
            peak_mem_bytes=int(d.get("peakMemBytes", 0)),
            cpu_seconds=float(d.get("cpuSeconds", 0.0)),
            oom=bool(d.get("oom", False)), reason=d.get("reason", ""),
        )


class ClusterAdapter(Protocol):
    """What the resource manager must implement for the CWS."""

    def launch(self, task: Task, node: str, mem_alloc: int) -> None: ...

    def kill(self, task_id: str) -> None: ...


class QuotaExceededError(ValueError):
    """A submit was rejected by the tenant's ``max_queued`` quota.

    Distinct from plain ``ValueError`` so the CWSI can answer 429 (back
    off and retry) instead of 400 (client bug): a quota rejection is a
    *policy* outcome on a well-formed request."""


@dataclass
class _NodeState:
    info: NodeInfo
    cpus_free: float
    mem_free: int
    chips_free: int
    up: bool = True
    est_available_at: float = 0.0

    def view(self) -> NodeView:
        return NodeView(
            name=self.info.name,
            cpus_total=self.info.cpus,
            mem_total=self.info.mem_bytes,
            cpus_free=self.cpus_free,
            mem_free=self.mem_free,
            chips_total=self.info.chips,
            chips_free=self.chips_free,
            speed_factor=self.info.speed_factor,
            labels=dict(self.info.labels),
            est_available_at=self.est_available_at,
        )


@dataclass
class _Allocation:
    node: str
    cpus: float
    mem: int
    chips: int
    workflow_id: str = ""
    # gang launches: ALL member nodes (head first); cpus/mem/chips above
    # stay PER NODE — every member holds exactly that much. Empty for
    # plain single-node launches, so pre-gang snapshots unpickle as-is.
    members: Tuple[str, ...] = ()


def _alloc_cost(alloc: _Allocation, totals: Dict[str, float]) -> float:
    """Dominant-share cost of one allocation: a gang is ONE task holding
    k nodes' worth of resources. Gated on membership so every
    single-node allocation takes the exact pre-gang float path."""
    k = len(alloc.members)
    if k > 1:
        return dominant_cost(alloc.cpus * k, alloc.mem * k,
                             alloc.chips * k, totals)
    return dominant_cost(alloc.cpus, alloc.mem, alloc.chips, totals)


@dataclass
class RetiredWorkflow:
    """Bounded tombstone of an evicted finished workflow.

    A long-running CWSI server retires finished DAGs out of ``dags``
    (memory stays launch-bound, not history-bound) but keeps the final
    task states around so late state queries over the CWSI still answer;
    late/duplicate completion reports are simply ignored."""

    workflow_id: str
    name: str
    succeeded: bool
    retired_at: float
    task_states: Dict[str, str]


class CommonWorkflowScheduler:
    """Workflow-aware scheduler engine behind the CWSI."""

    def __init__(
        self,
        adapter: ClusterAdapter,
        strategy: str | Strategy = "rank_min_rr",
        provenance: Optional[ProvenanceStore] = None,
        predictor: Optional[LotaruPredictor] = None,
        mem_predictor: Optional[FeedbackMemoryPredictor] = None,
        enable_speculation: bool = False,
        speculation_factor: float = 1.8,
        speculation_min_runtime: float = 30.0,
        staging_bandwidth: float = 1e9,
        use_predicted_memory: bool = False,
        legacy_scan: bool = False,
        sync_schedule: bool = False,
        decision_lag: float = 0.0,
        arbiter: str | Arbiter = "first_appearance",
        retire_finished: bool = True,
        retired_max: int = 256,
        max_preemptions_per_round: int = 0,
        registration_ttl: Optional[float] = 3600.0,
        report_lease: Optional[float] = None,
        quarantine_threshold: int = 0,
        quarantine_duration: float = 300.0,
        retry_anti_affinity: bool = False,
        request_dedup_window: int = 1024,
    ) -> None:
        self.adapter = adapter
        # write-ahead journal (core/journal.py). None (the default) keeps
        # today's inline behaviour exactly; Journal.attach() sets it, after
        # which every apply() append-logs the command BEFORE it runs.
        self.journal = None
        self.strategy: Strategy = (
            make_strategy(strategy) if isinstance(strategy, str) else strategy
        )
        self.provenance = provenance if provenance is not None else ProvenanceStore()
        self.predictor = predictor
        self.mem_predictor = mem_predictor
        self.enable_speculation = enable_speculation
        self.speculation_factor = speculation_factor
        self.speculation_min_runtime = speculation_min_runtime
        self.staging_bandwidth = staging_bandwidth
        self.use_predicted_memory = use_predicted_memory

        self.nodes: Dict[str, _NodeState] = {}
        self.dags: Dict[str, WorkflowDAG] = {}
        self.allocations: Dict[str, _Allocation] = {}
        self.mem_allocated: Dict[str, int] = {}          # task_id -> bytes granted
        # speculative copies: copy_id -> (copy Task, original id); and reverse
        self.spec_copies: Dict[str, Task] = {}
        self.spec_of_original: Dict[str, str] = {}
        self.on_workflow_done: Optional[Callable[[str], None]] = None
        # per-workflow strategy overrides (CWSI PUT /workflow/{wid}/strategy)
        self.workflow_strategies: Dict[str, Strategy] = {}
        # --- incremental ready queue (the live scheduling path) ---
        # READY tasks awaiting resources, in promotion order. Updated on
        # submit/finish/fail/node events; schedule() only drains newly
        # runnable tasks when the dirty flag is set, so a round is
        # O(ready), not O(all tasks of all DAGs).
        self._ready: Dict[str, Task] = {}
        self._dirty_dags: Dict[str, None] = {}
        self._queue_dirty = True
        # per-workflow ready-membership versions, backing the priority-
        # order cache (a workflow's sorted ready queue is reused across
        # rounds until its membership or its strategy's token moves)
        self._bucket_version: Dict[str, int] = {}
        self._ready_seq = _Seq(1)
        # wid -> (cache token, [(priority key, task), ...] sorted)
        self._order_cache: Dict[str, Tuple[Any, List[Tuple[Any, Task]]]] = {}
        self.priority_sorts = 0        # full per-workflow queue sorts
        self.priority_cache_hits = 0   # rounds served from the order cache
        # legacy_scan=True restores the pre-incremental full-scan rounds
        # and the index-free placement walk (benchmark baseline +
        # determinism checks); decisions are identical.
        self.legacy_scan = legacy_scan
        # --- coalesced scheduling rounds (the event→decision hot path) ---
        # Events do not run a round inline: they call request_schedule(),
        # which marks the scheduler pending; the driver (simulator, CWSI
        # clock advance, executor poll loop) drains every same-timestamp
        # event and then runs ONE round via schedule_pending(), collapsing
        # a W-wide same-timestamp completion burst from W rounds into 1.
        # sync_schedule=True restores the round-per-event cadence for
        # baseline benchmarking. Whole-DAG submission stays a synchronous
        # barrier in both modes (each tenant's DAG is answered by a round
        # of its own, which pins multi-tenant same-timestamp submission
        # decisions to the sync cadence).
        self.sync_schedule = sync_schedule
        self._sched_pending = False
        self.sched_round_events = 0    # schedule requests absorbed by rounds
        self.sched_rounds = 0
        # --- cross-timestamp micro-batching (decision lag) ---
        # With decision_lag > 0 a pending round may be deferred past its
        # requesting instant: the FIRST request of a batch stamps a
        # deadline (request time + lag) and the driver keeps absorbing
        # later-timestamp events into the same round until the deadline
        # passes — trading per-task decision latency (bounded by the lag)
        # for fewer, larger rounds. 0.0 makes the deadline the request's
        # own instant, which is exactly the same-timestamp-only coalescing
        # above: decisions are bit-identical to the lag-free engine.
        if not isinstance(decision_lag, (int, float)) \
                or isinstance(decision_lag, bool) \
                or not math.isfinite(decision_lag) or decision_lag < 0:
            raise ValueError(
                f"decision_lag must be a finite number >= 0, "
                f"got {decision_lag!r}")
        if decision_lag > 0 and sync_schedule:
            raise ValueError(
                "decision_lag requires coalesced rounds "
                "(sync_schedule=True runs every round inline)")
        self.decision_lag = float(decision_lag)
        # earliest instant the pending round must run at (inf = no batch
        # open); request_schedule keeps the MIN so a batch's deadline is
        # anchored to its first request, not pushed out by later ones
        self._sched_deadline = math.inf
        # tasks settled for good (SUCCEEDED or terminal ERROR) — the
        # drivers' liveness signal: a run making no settlements while
        # events keep firing is requeue-churning, not progressing
        self.tasks_settled = 0
        # --- O(1) unfinished-work tracking ---
        # wids of DAGs with unterminated tasks, maintained at the state
        # transitions (submit adds, the last settlement removes, retire/
        # reap/replace reconcile). Periodic drivers (the simulator's
        # SPEC_CHECK re-arm) consult this instead of scanning every live
        # DAG per wakeup — hundreds of tenants x periodic wakeups made
        # that scan quadratic drag.
        self._unfinished: Dict[str, None] = {}
        # engine-issued launch ids: on_task_started/on_task_finished reports
        # carrying a stale id (a dead launch racing its relaunch) are
        # rejected without the adapter needing its own generation masking
        self._launch_seq = _Seq(1)
        # --- inter-workflow arbitration (arbiter.py) ---
        # the arbiter interleaves per-workflow priority lists; shares feed
        # fair-share / strict-priority policies (CWSI PUT .../share)
        self.arbiter: Arbiter = (
            make_arbiter(arbiter) if isinstance(arbiter, str) else arbiter
        )
        self.workflow_shares: Dict[str, float] = {}
        self.arbiter_rounds = 0
        # --- preemptive arbitration (kill/requeue on share changes) ---
        # A share/arbiter change or a new tenant's arrival *arms* one
        # preemption pass; the next scheduling round consults
        # arbiter.preempt() for victim launches (at most
        # max_preemptions_per_round per pass). 0 (the default) disables
        # the whole path: preempt() is never called and every decision is
        # bit-identical to the non-preemptive engine (pinned by the
        # golden traces, the bench flag, and the equivalence property).
        self.max_preemptions_per_round = max_preemptions_per_round
        self._preempt_pending = False
        # dominant-share cost of preempted-but-not-relaunched work, per
        # victim workflow (wid -> task_id -> cost). The fairness view
        # keeps charging it (ArbiterContext.charged_usage) so a victim
        # cannot win back its own freed slot in the very next emission;
        # an entry clears when its task launches again or terminates.
        self._preempt_debt: Dict[str, Dict[str, float]] = {}
        self.preemptions = 0           # victim launches killed + requeued
        self.preempt_rounds = 0        # rounds that consulted preempt()
        self.preempt_triggers = 0      # share/arbiter/tenant-arrival arms
        # --- per-tenant queue quotas (CWSI PUT .../quota) ---
        # max_running is enforced at emission (the fair-share deficit-heap
        # pop skips capped workflows in O(log W)) AND at launch (an O(1)
        # guard that covers every arbiter); max_queued is enforced at
        # submission (QuotaExceededError -> CWSI 429).
        self.workflow_quotas: Dict[str, WorkflowQuota] = {}
        # --- registration TTL (reap abandoned empty registrations) ---
        # Completion-driven retirement cannot see a workflow that was
        # registered but never given tasks (nothing ever completes), so
        # one empty DAG used to leak per abandoned registration. Empty
        # registrations sit in this insertion-ordered map (wid ->
        # registered_at) and are reaped once older than the TTL; the
        # entry leaves the moment the workflow receives its first task.
        # None disables reaping.
        self.registration_ttl = registration_ttl
        self._empty_regs: Dict[str, float] = {}
        self.reaped_registrations = 0
        # --- orphaned-policy TTL (same leak, policy-shaped) ---
        # set_workflow_share / set_workflow_quota on a wid that never
        # registers used to persist forever (shares may legitimately be
        # declared pre-registration, so there is no error to raise).
        # Orphaned policy sits in this insertion-ordered map (wid ->
        # last_policy_set_at) and reaps under the same TTL; registration
        # lifts the wid out, after which retirement owns the cleanup.
        self._orphan_policy: Dict[str, float] = {}
        self.reaped_policies = 0
        # --- incremental arbiter accounting ---
        # Cluster totals and per-workflow dominant-resource usage are
        # maintained as deltas on launch/release (and recharged on the
        # rare node join/leave), not rescanned per round. Per workflow we
        # keep the charged cost of each running allocation in insertion
        # order and re-sum only workflows whose allocation set changed —
        # structurally the same float additions as the old global rescan,
        # so the resulting usage values are bit-identical.
        self._totals_cache: Optional[Dict[str, float]] = None
        self._usage_costs: Dict[str, Dict[str, float]] = {}
        self._usage_cache: Dict[str, float] = {}
        self._usage_dirty: Dict[str, None] = {}
        self._charges_stale = False    # totals moved: recharge every entry
        self.usage_delta_ops = 0       # incremental charge/discharge ops
        self.usage_scan_ops = 0        # allocation entries (re-)summed
        # --- patch-based node views ---
        self.view_snapshots = 0        # whole-node view() materialisations
        self.view_patches = 0          # single-node in-place view updates
        # --- placement feasibility index ---
        # Ready tasks bucket by resource-demand signature
        # (chips, cpus, mem_alloc). A bucket no up-node can fit is recorded
        # here and skipped without re-probing until cluster capacity can
        # have *grown* (task release / node join bumps the version); within
        # a round capacity only shrinks, so entries stay valid across
        # launches. This makes placement probes per round proportional to
        # feasible work, not to the unplaceable backlog.
        self._infeasible: Dict[Tuple[int, float, int], None] = {}
        self._capacity_version = 0
        self._infeasible_version = 0
        self.placement_probes = 0      # placement attempts (indexed or oracle)
        self.feasibility_checks = 0    # demand-vs-watermark bucket checks
        # --- node-capacity index (node_index.py): O(log N) placement ---
        # Order statistics over the up-nodes, maintained as launch/
        # release/churn deltas. schedule() resolves the feasibility
        # watermark, the per-round mem cap, and every strategy that
        # declares a ``place_key`` against it, materialising a NodeView
        # only when an oracle (non-indexable) placement needs the full
        # snapshot. legacy_scan=True disables it entirely, restoring the
        # pre-index O(N)-per-launch cost model; decisions are identical
        # either way (golden traces + the node-index oracle suite).
        self._node_index: Optional[NodeCapacityIndex] = (
            None if legacy_scan else NodeCapacityIndex())
        self.node_fit_ops = 0          # per-node fit evaluations (oracle side)
        self.view_materializations = 0  # NodeView objects built, engine-wide
        # --- finished-workflow eviction (bounded tombstones) ---
        # A finished workflow's DAG is retired out of ``dags`` so a
        # long-running server's memory tracks live work, not history.
        # Tombstones keep final task states for late CWSI state queries;
        # late completion reports for evicted workflows are ignored.
        self.retire_finished = retire_finished
        self.retired_max = retired_max
        self._retired: Dict[str, RetiredWorkflow] = {}
        # op counters of retired DAGs, folded in so op_counts() stays a
        # whole-history view after eviction
        self._retired_readiness_ops = 0
        self._retired_rank_ops = 0
        # --- report leases (presume silent launches lost) ---
        # A launch that produces no start/finish report within
        # ``report_lease`` seconds is presumed lost: the engine burns its
        # launch id, kills it at the adapter, and requeues the task
        # through the existing requeue seam (the stale-launch-id guards
        # reject the dead launch's late reports). The lease re-arms on
        # the start report to bound the silence until completion — size
        # it above the longest expected task runtime. ``_leases`` maps
        # task_id -> (launch_id, deadline); with a constant lease
        # duration and monotonic time, insertion order IS deadline
        # order, so expiry scans stop at the first live entry.
        # None (the default) disables the whole path.
        if report_lease is not None and (
                isinstance(report_lease, bool)
                or not isinstance(report_lease, (int, float))
                or not math.isfinite(report_lease) or report_lease <= 0):
            raise ValueError(
                f"report_lease must be a finite number > 0 or None, "
                f"got {report_lease!r}")
        self.report_lease = (None if report_lease is None
                             else float(report_lease))
        self._leases: Dict[str, Tuple[int, float]] = {}
        self.lease_expiries = 0
        # --- failure-domain quarantine (suspicion scoring) ---
        # Every lease expiry and task failure on a node bumps its
        # suspicion count; at ``quarantine_threshold`` the node is
        # temporarily excluded from placement (it leaves the capacity
        # index but stays up — running work continues) for
        # ``quarantine_duration`` seconds. 0 (the default) disables
        # scoring entirely; decisions are bit-identical.
        self.quarantine_threshold = quarantine_threshold
        self.quarantine_duration = float(quarantine_duration)
        self._suspicion: Dict[str, int] = {}
        # name -> release deadline; constant duration + monotonic time
        # keeps insertion order = deadline order (like ``_leases``)
        self._quarantined: Dict[str, float] = {}
        self.quarantines = 0
        self.quarantine_releases = 0
        # --- anti-affinity retry placement ---
        # A requeued task remembers the node its previous launch died on
        # (one-shot ``Task.avoid_node``) and the next round steers it to
        # any other fitting node; if only the killer fits, availability
        # wins over affinity. Off by default: placement is untouched.
        self.retry_anti_affinity = retry_anti_affinity
        self.anti_affinity_redirects = 0
        # --- exactly-once request window (CWSI requestId dedup) ---
        # Client-supplied requestIds on mutating CWSI calls land here
        # (insertion-ordered rid -> cached response envelope or None,
        # bounded FIFO). The marker is inserted by apply() AFTER the
        # command runs, and the request_id travels inside the journaled
        # command, so replay rebuilds the window and recovery preserves
        # exactly-once (a retried request after a crash is still
        # recognised — it gets a generic duplicate-ack instead of the
        # cached envelope, which did not survive).
        self.request_dedup_window = request_dedup_window
        self._seen_requests: Dict[str, Optional[str]] = {}
        self.duplicate_requests = 0
        # --- gang placement (Resources.nodes > 1) ---
        self.gang_launches = 0         # gangs placed (any width)
        self.gang_resizes = 0          # gangs launched below requested width
        self.gang_preemptions = 0      # gang launches killed by the arbiter

    # ------------------------------------------------------------------
    # the command seam
    # ------------------------------------------------------------------
    def apply(self, cmd: "_cmd.Command", now: float = 0.0) -> Any:
        """Apply one command record — the single mutation entry point.

        Ordering is the WAL contract: ``validate`` raises first (a
        rejected request never reaches the journal and never mutates),
        then the command is appended to the journal (write-ahead: the log
        always covers at least what the engine has done), then it runs.
        With no journal attached this is exactly the pre-seam call.
        """
        cmd.validate(self)
        journal = self.journal
        if journal is not None:
            journal.append(now, cmd)
        result = cmd.run(self, now)
        rid = getattr(cmd, "request_id", None)
        if rid is not None:
            # the marker rides the journaled command, so replay rebuilds
            # the dedup window exactly (exactly-once survives recovery);
            # rejected requests never reach here — they may be retried
            self._seen_requests[rid] = None
            while len(self._seen_requests) > self.request_dedup_window:
                del self._seen_requests[next(iter(self._seen_requests))]
        if journal is not None and journal.snapshot_every > 0:
            journal.maybe_snapshot(self)
        return result

    def __getstate__(self):
        # Snapshots pickle the engine. Excluded on purpose: the adapter
        # (a live resource manager / simulator — recovery re-wires its
        # own), the journal (the snapshot lives *inside* it), the
        # completion callback, and any instance-level ``schedule``
        # override (benchmarks monkeypatch a timing closure over the
        # method; a closure is not engine state).
        state = dict(self.__dict__)
        for k in ("adapter", "journal", "on_workflow_done", "schedule"):
            state.pop(k, None)
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self.adapter = None
        self.journal = None
        self.on_workflow_done = None

    # ------------------------------------------------------------------
    # resource-manager side: infrastructure events
    # ------------------------------------------------------------------
    def add_node(self, info: NodeInfo, now: float = 0.0) -> None:
        self.apply(_cmd.AddNode(info), now)

    def _apply_add_node(self, info: NodeInfo, now: float) -> None:
        # a re-joining name starts with a clean record (the old hardware
        # is gone; keeping its quarantine would double-add on release)
        self._suspicion.pop(info.name, None)
        self._quarantined.pop(info.name, None)
        self.nodes[info.name] = _NodeState(
            info=info,
            cpus_free=info.cpus,
            mem_free=info.mem_bytes,
            chips_free=info.chips,
        )
        if self._node_index is not None:
            self._node_index.add(info.name, self.nodes[info.name])
        self._capacity_version += 1
        self._invalidate_totals()
        self.provenance.record_node_event(NodeEvent(info.name, now, "UP"))
        if self.predictor is not None:
            self.predictor.register_node_bench(
                NodeProfile(info.name, info.speed_factor)
            )
        self.request_schedule(now)

    def remove_node(self, name: str, now: float = 0.0) -> None:
        self.apply(_cmd.RemoveNode(name), now)

    def _apply_remove_node(self, name: str, now: float) -> None:
        """Node failure / scale-in: requeue everything running there.

        Every victim's allocation/memory bookkeeping is released (it used
        to leak). Speculative copies that died with the node are killed
        and their pairing cleaned up — a copy is not a DAG task, so
        "requeuing" it would strand it READY forever while its stale
        ``spec_of_original`` entry blocks any future speculation and makes
        the original's success kill a phantom.
        """
        st = self.nodes.get(name)
        if st is None:
            return
        st.up = False
        if self._node_index is not None and name not in self._quarantined:
            # a quarantined node already left the index
            self._node_index.remove(name)
        self._quarantined.pop(name, None)
        self._suspicion.pop(name, None)
        self._invalidate_totals()
        self.provenance.record_node_event(NodeEvent(name, now, "DOWN"))
        # a gang dies with ANY of its members: the launch is all-or-
        # nothing, so losing one node requeues the whole gang (surviving
        # members' capacity comes back through the same _release)
        victims = [tid for tid, a in self.allocations.items()
                   if a.node == name or name in a.members]
        for tid in victims:
            self._release(tid)
            copy = self.spec_copies.pop(tid, None)
            if copy is not None:
                if copy.speculative_of is not None:
                    self.spec_of_original.pop(copy.speculative_of, None)
                copy.state = TaskState.KILLED
                copy.end_time = now
                self._record(copy, "KILLED",
                             TaskResult(False, reason=f"node {name} lost"))
                self.mem_allocated.pop(tid, None)
                self.adapter.kill(tid)
                continue
            task = self._find_task(tid)
            if task is not None:
                self._handle_failure(
                    task, now, TaskResult(False, reason=f"node {name} lost"),
                    requeue_free=True,
                )
        del self.nodes[name]
        self._capacity_version += 1
        self.request_schedule(now)

    def set_node_speed(self, name: str, speed_factor: float, now: float = 0.0) -> None:
        self.apply(_cmd.SetNodeSpeed(name, speed_factor), now)

    def _apply_set_node_speed(self, name: str, speed_factor: float,
                              now: float) -> None:
        if name in self.nodes:
            self.nodes[name].info.speed_factor = speed_factor
            if self._node_index is not None:
                self._node_index.on_speed_change(name)
            self.provenance.record_node_event(
                NodeEvent(name, now, "SLOW" if speed_factor < 1.0 else "RECOVERED",
                          {"speed": speed_factor})
            )
            if self.predictor is not None:
                self.predictor.register_node_bench(NodeProfile(name, speed_factor))

    # ------------------------------------------------------------------
    # SWMS side (invoked by the CWSI server)
    # ------------------------------------------------------------------
    def register_workflow(self, workflow_id: str, name: str = "",
                          meta: Optional[Dict[str, Any]] = None,
                          now: float = 0.0) -> WorkflowDAG:
        return self.apply(_cmd.RegisterWorkflow(workflow_id, name, meta), now)

    def _apply_register_workflow(self, workflow_id: str, name: str,
                                 meta: Optional[Dict[str, Any]],
                                 now: float) -> WorkflowDAG:
        self._reap_registrations(now)
        self._orphan_policy.pop(workflow_id, None)
        if workflow_id in self.dags:
            if not self.dags[workflow_id].tasks:
                # still empty: a re-register refreshes its TTL window
                self._empty_regs.pop(workflow_id, None)
                self._empty_regs[workflow_id] = now
            return self.dags[workflow_id]
        self._retired.pop(workflow_id, None)   # id reborn: drop tombstone
        dag = WorkflowDAG(workflow_id, name)
        self.dags[workflow_id] = dag
        self._empty_regs[workflow_id] = now
        self.provenance.register_workflow(
            workflow_id, {"name": name, **(meta or {})}
        )
        self._arm_preemption()                 # a new tenant arrived
        return dag

    def submit_task(self, spec: TaskSpec, deps: Tuple[str, ...] = (),
                    now: float = 0.0) -> Task:
        return self.apply(_cmd.SubmitTask(spec, tuple(deps)), now)

    def _apply_submit_task(self, spec: TaskSpec, deps: Tuple[str, ...],
                           now: float, schedule: bool = False) -> Task:
        dag = self.dags.get(spec.workflow_id)
        pending = dag is None
        self._check_queued_quota(spec.workflow_id, dag, adding=1)
        if pending:
            # build first, register only if the submit is valid: a rejected
            # task must not leave a half-registered workflow behind
            dag = WorkflowDAG(spec.workflow_id)
        task = dag.add_task(spec, deps)
        if pending:
            self._retired.pop(spec.workflow_id, None)
            self.dags[spec.workflow_id] = dag
            self.provenance.register_workflow(spec.workflow_id, {"name": ""})
            self._arm_preemption()             # a new tenant arrived
        self._empty_regs.pop(spec.workflow_id, None)
        self._orphan_policy.pop(spec.workflow_id, None)
        # the accepted task is unterminated by construction
        self._unfinished[spec.workflow_id] = None
        task.submit_time = now
        self._mark_dirty(spec.workflow_id)
        if schedule:
            # CWSI POST .../task cadence: each accepted task requests a
            # round (coalesced by the driver); part of the command so
            # replay reproduces sched_round_events and round timing
            self.request_schedule(now)
        return task

    def submit_workflow(self, dag: WorkflowDAG, now: float = 0.0) -> None:
        self.apply(_cmd.SubmitWorkflow(dag), now)

    def _apply_submit_workflow(self, dag: WorkflowDAG, now: float) -> None:
        dag.validate()
        old = self.dags.get(dag.workflow_id)
        if old is not dag:
            # a replacement drops the old DAG's queue, so only the new
            # tasks count against max_queued
            self._check_queued_quota(dag.workflow_id, None,
                                     adding=len(dag.tasks))
        if old is not None and old is not dag:
            # a replaced DAG's running tasks would complete onto same-id
            # tasks of the new DAG (phantom successes, leaked allocations)
            if any(t.state.active for t in old.tasks.values()):
                raise ValueError(
                    f"cannot replace workflow {dag.workflow_id!r} while "
                    f"tasks are still scheduled or running")
            # replacing an idle workflow: drop the old DAG's queued tasks
            for tid in [t for t, task in self._ready.items()
                        if task.spec.workflow_id == dag.workflow_id]:
                self._ready_discard(tid, dag.workflow_id)
            # version-keyed caches (e.g. HEFT's rank memo) are scoped by
            # workflow id: keep versions monotonic across the replacement
            # so the new DAG can never collide with the old one's entries
            dag.version = max(dag.version, old.version + 1)
            # the old DAG is gone: release strategy/order caches keyed to it
            self._evict_workflow_caches(dag.workflow_id)
        self._retired.pop(dag.workflow_id, None)
        if old is None:
            self._arm_preemption()             # a new tenant arrived
        if old is not None and old is not dag:
            # the replaced DAG's preempted-work debt charges dead tasks
            self._preempt_debt.pop(dag.workflow_id, None)
        self.dags[dag.workflow_id] = dag
        if dag.finished():                     # empty DAG: vacuously done
            self._unfinished.pop(dag.workflow_id, None)
        else:
            self._unfinished[dag.workflow_id] = None
        self._orphan_policy.pop(dag.workflow_id, None)
        # an empty whole-DAG submission is registration-shaped: it ages
        # out under the TTL like a bare registration (re-submission with
        # tasks, or any later task submit, lifts it out)
        self._empty_regs.pop(dag.workflow_id, None)
        if not dag.tasks:
            self._empty_regs[dag.workflow_id] = now
        self.provenance.register_workflow(dag.workflow_id, {"name": dag.name})
        for t in dag.tasks.values():
            t.submit_time = now
        self._mark_dirty(dag.workflow_id)
        # whole-DAG submission is a synchronous scheduling barrier even in
        # coalesced mode (see __init__): the round runs inline
        self.sched_round_events += 1
        self.schedule(now)

    def set_workflow_strategy(self, workflow_id: str,
                              strategy: str | Strategy,
                              now: float = 0.0) -> Strategy:
        """Per-workflow strategy override (CWSI: PUT .../strategy).

        Only tasks of ``workflow_id`` are prioritized/placed by it; all
        other workflows keep the scheduler-wide strategy.
        """
        return self.apply(_cmd.SetStrategy(workflow_id, strategy), now)

    def _apply_set_strategy(self, workflow_id: str,
                            strat: Strategy) -> Strategy:
        old = self.workflow_strategies.get(workflow_id)
        self.workflow_strategies[workflow_id] = strat
        # the cached order was computed by the previous strategy — drop it
        # (the name-based cache key cannot tell two same-name strategy
        # objects apart) and let the replaced override release any
        # per-workflow state of its own
        self._order_cache.pop(workflow_id, None)
        if old is not None and old is not strat and old is not self.strategy:
            old.on_workflow_done(workflow_id)
        return strat

    def _strategy_for(self, task: Task) -> Strategy:
        return self.workflow_strategies.get(task.spec.workflow_id, self.strategy)

    # ------------------------------------------------------------------
    # inter-workflow arbitration (CWSI: PUT .../share, GET/PUT /arbiter)
    # ------------------------------------------------------------------
    def set_workflow_share(self, workflow_id: str, share: float,
                           now: float = 0.0) -> float:
        """Set a workflow's fair-share weight / strict priority.

        Weights default to 1.0; zero means best-effort (ordered after all
        positive-share ready work each round, so it only gets capacity the
        positive-share tenants cannot use). May be set before the workflow
        registers — shares are tenant policy, not DAG state (an orphaned
        pre-registration share reaps under the registration TTL). The
        share is cleared when the workflow finishes and retires:
        re-declare it before rerunning the same id. No coercion: a client
        sending ``"2.5"`` or ``true`` has a bug the wire contract
        promises to surface as 400, not paper over.
        """
        return self.apply(_cmd.SetShare(workflow_id, share), now)

    def _apply_set_share(self, workflow_id: str, share: float,
                         now: float) -> float:
        self.workflow_shares[workflow_id] = share
        self._stamp_orphan_policy(workflow_id, now)
        self._mark_dirty(workflow_id)
        self._arm_preemption()                 # shares moved under running work
        return share

    def set_arbiter(self, arbiter: str | Arbiter,
                    now: float = 0.0) -> Arbiter:
        """Swap the inter-workflow arbitration policy."""
        return self.apply(_cmd.SetArbiter(arbiter), now)

    def _apply_set_arbiter(self, arbiter: Arbiter) -> Arbiter:
        self.arbiter = arbiter
        self._arm_preemption()                 # the fairness regime changed
        return self.arbiter

    def set_workflow_quota(self, workflow_id: str,
                           max_running: Optional[int] = None,
                           max_queued: Optional[int] = None,
                           now: float = 0.0) -> WorkflowQuota:
        """Set a tenant's queue quota (CWSI: PUT .../quota).

        Each bound is a non-negative integer or ``None`` (unlimited); as
        with shares there is no coercion — a float (NaN and inf
        included), bool, or string is a client bug the wire contract
        surfaces as 400, mutating nothing. Both bounds ``None`` clears
        the quota. ``max_running`` caps concurrently allocated launches
        (enforced at emission and at launch); ``max_queued`` caps queued
        tasks (enforced at submission — the CWSI answers 429). Quotas
        retire with the workflow (orphaned pre-registration quotas reap
        under the registration TTL); re-declare before rerunning the id."""
        return self.apply(
            _cmd.SetQuota(workflow_id, max_running, max_queued), now)

    def _apply_set_quota(self, workflow_id: str,
                         max_running: Optional[int],
                         max_queued: Optional[int],
                         now: float) -> WorkflowQuota:
        quota = WorkflowQuota(max_running=max_running, max_queued=max_queued)
        if quota.max_running is None and quota.max_queued is None:
            self.workflow_quotas.pop(workflow_id, None)
        else:
            self.workflow_quotas[workflow_id] = quota
        self._stamp_orphan_policy(workflow_id, now)
        self._mark_dirty(workflow_id)
        return quota

    def _stamp_orphan_policy(self, workflow_id: str, now: float) -> None:
        """(Re-)stamp the orphan TTL after a share/quota change: policy
        on an unregistered wid ages from its LAST declaration; policy on
        a registered wid (or a wid whose policy just cleared) is owned by
        retirement, not the TTL."""
        self._orphan_policy.pop(workflow_id, None)
        if workflow_id in self.dags:
            return
        if (workflow_id in self.workflow_shares
                or workflow_id in self.workflow_quotas):
            self._orphan_policy[workflow_id] = now

    def _running_count(self, workflow_id: str) -> int:
        """Live allocation count of one workflow, O(1) on the live path
        (the incremental usage map's key set IS the allocation set,
        restricted per workflow)."""
        if not self.legacy_scan:
            return len(self._usage_costs.get(workflow_id, ()))
        return sum(1 for a in self.allocations.values()
                   if a.workflow_id == workflow_id)

    def _queued_count(self, dag: Optional[WorkflowDAG]) -> int:
        """Queued = non-terminal DAG tasks minus running DAG launches.

        ``_running_count`` deliberately includes speculative copies (they
        hold real resources, so they count against ``max_running``), but
        a copy is not a DAG task: leaving it in here would undercount
        the queue by one per live copy and under-enforce ``max_queued``.
        """
        if dag is None:
            return 0
        wid = dag.workflow_id
        running = self._running_count(wid)
        if running and self.spec_copies:
            running -= sum(
                1 for copy in self.spec_copies.values()
                if copy.spec.workflow_id == wid
                and copy.task_id in self.allocations)
        return max(dag._n_unterminated - max(running, 0), 0)

    def _check_queued_quota(self, workflow_id: str,
                            dag: Optional[WorkflowDAG], adding: int) -> None:
        quota = self.workflow_quotas.get(workflow_id)
        if quota is None or quota.max_queued is None:
            return
        if self._queued_count(dag) + adding > quota.max_queued:
            raise QuotaExceededError(
                f"workflow {workflow_id!r} is at its max_queued quota "
                f"({quota.max_queued}); retry after queued tasks drain")

    def _arm_preemption(self) -> None:
        """A preemption trigger fired (share/arbiter change, new tenant).

        Only arms when preemption is enabled, so the default engine
        carries zero extra state through these events; the armed pass
        runs as part of the next scheduling round (the flag also marks
        the engine pending so a lone share change still gets a round)."""
        if self.max_preemptions_per_round > 0:
            self._preempt_pending = True
            self._sched_pending = True
            # run at the very next batch end regardless of decision_lag:
            # a policy change under running work must not wait out a
            # micro-batching window (and this path has no ``now`` to
            # anchor one — -inf beats any later request's deadline)
            self._sched_deadline = -math.inf
            self.preempt_triggers += 1

    def _invalidate_totals(self) -> None:
        """Node membership/up-state changed: totals and every allocation's
        dominant-cost charge (a fraction *of those totals*) are stale."""
        self._totals_cache = None
        self._charges_stale = True

    def _cluster_totals(self) -> Dict[str, float]:
        # recomputed only after node join/leave — same iteration order as
        # the old per-round scan, so the floats are bit-identical. The
        # live path reads the node index (whose entry set IS the up-node
        # set, in registration order); legacy_scan keeps the dict scan.
        if self._totals_cache is None:
            if self._node_index is not None:
                self._totals_cache = self._node_index.cluster_totals()
            else:
                up = [st.info for st in self.nodes.values()
                      if st.up and st.info.name not in self._quarantined]
                self._totals_cache = {
                    "cpus": sum(i.cpus for i in up),
                    "mem": float(sum(i.mem_bytes for i in up)),
                    "chips": float(sum(i.chips for i in up)),
                }
        return self._totals_cache

    def _charge_usage(self, task_id: str, wid: str, cpus: float, mem: int,
                      chips: int) -> None:
        if self.legacy_scan:
            return              # baseline cost model: rescan per read
        cost = dominant_cost(cpus, mem, chips, self._cluster_totals())
        self._usage_costs.setdefault(wid, {})[task_id] = cost
        self._usage_dirty[wid] = None
        self.usage_delta_ops += 1

    def _discharge_usage(self, task_id: str, wid: str) -> None:
        if self.legacy_scan:
            return
        entries = self._usage_costs.get(wid)
        if entries is None or entries.pop(task_id, None) is None:
            return
        if not entries:
            del self._usage_costs[wid]
        self._usage_dirty[wid] = None
        self.usage_delta_ops += 1

    def _workflow_usage(
        self, totals: Optional[Dict[str, float]] = None
    ) -> Dict[str, float]:
        """Dominant-resource usage of *running allocations*, per workflow.

        ``legacy_scan`` keeps the pre-incremental full rescan; the live
        path re-sums only workflows whose allocation set changed since the
        last read. Each workflow's entries are kept (and summed) in global
        allocation insertion order restricted to that workflow — the exact
        addition sequence of the full rescan — so both paths produce
        bit-identical floats (the hypothesis suite pins this).
        """
        if totals is None:
            totals = self._cluster_totals()
        if self.legacy_scan:
            usage: Dict[str, float] = {}
            for alloc in self.allocations.values():
                self.usage_scan_ops += 1
                cost = _alloc_cost(alloc, totals)
                usage[alloc.workflow_id] = (
                    usage.get(alloc.workflow_id, 0.0) + cost)
            return usage
        if self._charges_stale:
            # node join/leave: every charge is a fraction of the new
            # totals — rebuild all entries from the allocation map (rare)
            self._usage_costs.clear()
            for task_id, alloc in self.allocations.items():
                self.usage_scan_ops += 1
                self._usage_costs.setdefault(alloc.workflow_id, {})[
                    task_id
                ] = _alloc_cost(alloc, totals)
            self._usage_cache.clear()
            self._usage_dirty = dict.fromkeys(self._usage_costs)
            self._charges_stale = False
        for wid in self._usage_dirty:
            entries = self._usage_costs.get(wid)
            if not entries:
                self._usage_cache.pop(wid, None)
                continue
            total = 0.0
            for cost in entries.values():
                self.usage_scan_ops += 1
                total += cost
            self._usage_cache[wid] = total
        self._usage_dirty.clear()
        return dict(self._usage_cache)

    def _arbiter_context(
        self, ctx: SchedulingContext,
        ready_counts: Optional[Dict[str, int]] = None,
    ) -> ArbiterContext:
        return ArbiterContext(
            ctx=ctx,
            strategy_for=self._strategy_for,
            single_strategy=None if self.workflow_strategies else self.strategy,
            shares=self.workflow_shares,
            appearance_fn=lambda: {wid: i for i, wid in enumerate(self.dags)},
            usage_fn=self._workflow_usage,
            totals_fn=self._cluster_totals,
            keyed_queue_fn=(
                None if self.legacy_scan
                else lambda wid, tasks: self._keyed_queue(wid, tasks, ctx)),
            quotas=self.workflow_quotas,
            running_count_fn=self._running_count,
            ready_counts=ready_counts or {},
            preempt_debt=self._preempt_debt_sums(),
            max_preemptions=self.max_preemptions_per_round,
        )

    def _preempt_debt_sums(self) -> Dict[str, float]:
        """Per-workflow outstanding preemption debt (usually empty)."""
        if not self._preempt_debt:
            return {}
        return {wid: sum(entries.values())
                for wid, entries in self._preempt_debt.items()}

    def _keyed_queue(
        self, wid: str, tasks: List[Task], ctx: SchedulingContext
    ) -> Optional[List[Tuple[Any, Task]]]:
        """Cached sorted (priority key, task) queue for one workflow.

        Valid while the strategy's token (DAG/predictor versions) and the
        workflow's ready-bucket membership are unchanged. Keys carry the
        task's promotion sequence as a final component, so they are a
        total order and cached results are exactly the stable sort the
        strategy's prioritize() would produce. Returns None (→ caller
        falls back to prioritize()) for strategies with round-varying
        priorities.
        """
        strat = self.workflow_strategies.get(wid, self.strategy)
        token = strat.priority_token(ctx, self.dags.get(wid))
        if token is None:
            return None
        # keyed by strategy NAME, not id(): a cached order must survive a
        # pickle/unpickle recovery cycle (object ids do not), and a
        # same-name different-object swap always pops the cache first
        cache_key = (strat.name, token, self._bucket_version.get(wid, 0))
        hit = self._order_cache.get(wid)
        if hit is not None and hit[0] == cache_key:
            self.priority_cache_hits += 1
            return hit[1]
        self.priority_sorts += 1
        keyed = sorted(
            ((strat.priority_key(t, ctx) + (t.ready_seq,), t) for t in tasks),
            key=lambda kv: kv[0],
        )
        self._order_cache[wid] = (cache_key, keyed)
        return keyed

    def arbiter_status(self) -> Dict[str, Any]:
        """Status document for the CWSI ``GET /arbiter`` endpoint."""
        usage = self._workflow_usage(self._cluster_totals())
        active = [wid for wid, dag in self.dags.items() if not dag.finished()]
        debt = self._preempt_debt_sums()
        # deficits charge preempted-but-not-relaunched work to its victim
        # (the anti-oscillation accounting the arbiter itself orders by);
        # without preemptions this IS the plain running-usage deficit
        charged = ({wid: usage.get(wid, 0.0) + debt.get(wid, 0.0)
                    for wid in set(usage) | set(debt)} if debt else usage)
        return {
            "arbiter": self.arbiter.name,
            "shares": dict(self.workflow_shares),
            "usage": usage,
            "deficits": _share_deficits(self.workflow_shares, charged,
                                        active),
            "arbiterRounds": self.arbiter_rounds,
            "placementProbes": self.placement_probes,
            "feasibilityChecks": self.feasibility_checks,
            "infeasibleBuckets": len(self._infeasible),
            "quotas": {
                wid: {"maxRunning": q.max_running, "maxQueued": q.max_queued}
                for wid, q in self.workflow_quotas.items()
            },
            "preemptions": self.preemptions,
            "preemptRounds": self.preempt_rounds,
            "maxPreemptionsPerRound": self.max_preemptions_per_round,
            "preemptDebt": debt,
            "workflows": {
                wid: dag.state_counts() for wid, dag in self.dags.items()
            },
        }

    def _mark_dirty(self, workflow_id: str) -> None:
        self._queue_dirty = True
        self._dirty_dags[workflow_id] = None

    # ------------------------------------------------------------------
    # coalesced scheduling rounds
    # ------------------------------------------------------------------
    def request_schedule(self, now: float) -> int:
        """An event asked for a scheduling round.

        In the default coalesced mode this only marks the scheduler
        pending — the driver drains every same-timestamp event and then
        runs one round via ``schedule_pending``. With ``sync_schedule``
        the round runs inline (the pre-coalescing cadence)."""
        self.sched_round_events += 1
        if self.sync_schedule:
            return self.schedule(now)
        self._sched_pending = True
        # the batch's deadline anchors to its EARLIEST request: with
        # decision_lag == 0 this is the request's own instant (the driver
        # flushes at batch end exactly as before), with lag > 0 the
        # driver may absorb events up to ``decision_lag`` newer first
        deadline = now + self.decision_lag
        if deadline < self._sched_deadline:
            self._sched_deadline = deadline
        return 0

    def has_unfinished_work(self) -> bool:
        """O(1): any live workflow still has unterminated tasks. Periodic
        drivers re-arm on this instead of scanning every DAG."""
        return bool(self._unfinished)

    def schedule_pending(self, now: float) -> int:
        """Run the deferred round, if any event requested one.

        The no-op drain is checked BEFORE the command seam: drivers call
        this after every event batch, and journaling millions of no-op
        barriers would dwarf the real history. Only barriers that run a
        round reach the journal (replay re-arrives at the same pending
        state, so the recorded barrier drains identically)."""
        if not self._sched_pending:
            return 0
        return self.apply(_cmd.ScheduleBarrier(force=False), now)

    def _apply_schedule_barrier(self, force: bool, now: float) -> int:
        if not force and not self._sched_pending:
            return 0
        # attribute lookup, not a direct call: benchmarks time rounds by
        # monkeypatching an instance-level ``schedule`` closure
        return self.schedule(now)

    # ------------------------------------------------------------------
    # ready-queue maintenance (global dict + per-workflow buckets)
    # ------------------------------------------------------------------
    def _ready_add(self, task: Task) -> None:
        tid, wid = task.task_id, task.spec.workflow_id
        old = self._ready.get(tid)
        if old is not None and old.spec.workflow_id != wid:
            # task-id collision across workflows: _ready is keyed by task
            # id, so the newcomer evicts the holder — the holder's cached
            # order is stale too
            self._bucket_version[old.spec.workflow_id] = (
                self._bucket_version.get(old.spec.workflow_id, 0) + 1)
        task.ready_seq = next(self._ready_seq)
        self._ready[tid] = task
        self._bucket_version[wid] = self._bucket_version.get(wid, 0) + 1

    def _ready_discard(self, tid: str, wid: str) -> None:
        cur = self._ready.get(tid)
        if cur is None:
            return
        if cur.spec.workflow_id != wid:
            # the id is held by ANOTHER workflow's task (cross-workflow
            # task-id collision): not ours to drop — blindly popping here
            # would silently unqueue the other tenant's ready task
            return
        del self._ready[tid]
        self._bucket_version[wid] = self._bucket_version.get(wid, 0) + 1

    def _evict_workflow_caches(self, wid: str) -> None:
        """A workflow completed or was replaced: drop caches keyed to it
        (HEFT rank memos, sorted-queue cache) so a long-lived scheduler
        does not leak one entry per workflow ever scheduled."""
        self._order_cache.pop(wid, None)
        # safe to drop alongside the cache entry: a later re-add restarts
        # the version at 1 with no cached order to mismatch against
        self._bucket_version.pop(wid, None)
        self.strategy.on_workflow_done(wid)
        override = self.workflow_strategies.get(wid)
        if override is not None and override is not self.strategy:
            override.on_workflow_done(wid)

    def task_state(self, workflow_id: str, task_id: str) -> TaskState:
        dag = self.dags.get(workflow_id)
        if dag is not None:
            return dag.task(task_id).state
        retired = self._retired[workflow_id]       # KeyError → unknown wf
        return TaskState(retired.task_states[task_id])

    def workflow_done(self, workflow_id: str) -> bool:
        dag = self.dags.get(workflow_id)
        if dag is not None:
            return dag.finished()
        if workflow_id in self._retired:
            return True                            # only finished wfs retire
        raise KeyError(workflow_id)

    def retired_workflow(self, workflow_id: str) -> Optional[RetiredWorkflow]:
        """Tombstone of an evicted finished workflow, if still retained."""
        return self._retired.get(workflow_id)

    def _retire_workflow(self, dag: WorkflowDAG, now: float) -> None:
        """Evict a finished DAG wholesale (ROADMAP event-path item).

        The DAG leaves ``dags`` (readiness scans, arbiter appearance maps
        and op-count sums stop iterating history — relative order of the
        remaining workflows is preserved, so decisions don't move) and a
        bounded tombstone keeps the final task states for late CWSI
        queries. Oldest tombstones fall off first.

        Known limit: retirement is driven by task-completion events, so
        a workflow that was *registered but never given tasks* (client
        crashed between register and submit) is never retired — its
        empty DAG is vacuously finished but no completion ever fires.
        Reaping those needs a registration TTL, not completion events
        (ROADMAP future work); the leak is one empty DAG per abandoned
        registration, unchanged from the pre-eviction engine."""
        if not self.retire_finished:
            return
        wid = dag.workflow_id
        if self.dags.get(wid) is not dag:
            return
        del self.dags[wid]
        self._dirty_dags.pop(wid, None)
        self._unfinished.pop(wid, None)        # only finished wfs retire
        # per-workflow tenant policy retires with the workflow: keeping
        # strategy overrides and share weights for every id ever
        # scheduled would grow with history (the exact leak eviction
        # exists to close), and a reborn id must start fresh, not
        # inherit a dead tenant's policy. Re-declare policy over the
        # CWSI before resubmitting (shares may be set pre-registration).
        self.workflow_strategies.pop(wid, None)
        self.workflow_shares.pop(wid, None)
        self.workflow_quotas.pop(wid, None)
        self._preempt_debt.pop(wid, None)
        self._empty_regs.pop(wid, None)
        self._orphan_policy.pop(wid, None)
        self._retired_readiness_ops += dag.readiness_ops
        self._retired_rank_ops += dag.rank_ops
        self._retired.pop(wid, None)               # refresh recency on re-run
        self._retired[wid] = RetiredWorkflow(
            workflow_id=wid,
            name=dag.name,
            succeeded=dag.succeeded(),
            retired_at=now,
            task_states={tid: t.state.value for tid, t in dag.tasks.items()},
        )
        while len(self._retired) > self.retired_max:
            del self._retired[next(iter(self._retired))]

    # ------------------------------------------------------------------
    # execution callbacks (from the resource manager)
    # ------------------------------------------------------------------
    def on_task_started(self, task_id: str, now: float,
                        launch_id: Optional[int] = None) -> None:
        self.apply(_cmd.TaskStarted(task_id, launch_id), now)

    def _apply_task_started(self, task_id: str, now: float,
                            launch_id: Optional[int]) -> None:
        task = self._find_task(task_id)
        if task is None:
            return
        if launch_id is not None and launch_id != task.launch_id:
            # report from a dead launch (node lost, task relaunched
            # elsewhere): only the live launch may flip state
            return
        if task.state != TaskState.SCHEDULED:
            # only a scheduled launch may start. Anything else is a late
            # or duplicate report racing a kill: a settled task, a killed
            # speculative copy, or a node-loss-requeued READY task whose
            # old launch's start arrives after the requeue — none may be
            # flipped to RUNNING or have start_time clobbered.
            return
        task.state = TaskState.RUNNING
        task.start_time = now
        if self.report_lease is not None and task_id in self._leases:
            # start report arrived: re-arm for the finish report (the
            # lease now bounds the silence until completion — size
            # report_lease above the longest expected runtime)
            del self._leases[task_id]
            self._leases[task_id] = (task.launch_id,
                                     now + self.report_lease)

    def on_task_finished(self, task_id: str, now: float, result: TaskResult,
                         launch_id: Optional[int] = None) -> None:
        self.apply(_cmd.TaskFinished(task_id, result, launch_id), now)

    def _apply_task_finished(self, task_id: str, now: float,
                             result: TaskResult,
                             launch_id: Optional[int]) -> None:
        task = self._find_task(task_id)
        if task is None:
            return
        if launch_id is not None and launch_id != task.launch_id:
            # completion report from a dead launch (the task was requeued
            # and relaunched elsewhere): a late *success* here would settle
            # the task and release the live launch's allocation — the
            # protocol hole flagged in the CWSI rev, closed by the id
            return
        if task_id not in self.spec_copies:
            if task.state.terminal:
                # duplicate/late completion report (e.g. a kill racing a
                # real resource manager's finish): the task is settled.
                # The old full-scan engine re-derived readiness from
                # parent states so this was harmless; the counter-based
                # path must not let it double-decrement children's unmet
                # counts.
                return
            if not task.state.active:
                # requeue-window guard (the requeue-path audit): a task
                # sitting PENDING/READY has NO live launch — it was
                # requeued by node loss, a retried failure, or a
                # preemption, and its old launch is dead by engine
                # action. Any report here is that dead launch's late
                # echo; before this guard, a *lenient* (id-less) adapter
                # could settle the requeued task with it — crediting
                # outputs of a launch whose node may be gone — while
                # id-carrying adapters were already protected above.
                return
        task.end_time = now
        self._release(task_id)

        if task_id in self.spec_copies:
            self._finish_speculative_copy(task, now, result)
        elif result.success:
            self._finish_success(task, now, result)
        else:
            self._handle_failure(task, now, result)
        self.request_schedule(now)

    # ------------------------------------------------------------------
    # the scheduling core
    # ------------------------------------------------------------------
    def _context(self, now: float) -> SchedulingContext:
        return SchedulingContext(
            dags=self.dags,
            provenance=self.provenance,
            predictor=self.predictor,
            mem_predictor=self.mem_predictor,
            now=now,
            staging_bandwidth=self.staging_bandwidth,
        )

    def schedule(self, now: float) -> int:
        """Run one scheduling round; returns number of launches issued.

        The live path is incremental: the persistent ready queue is only
        extended (from DAGs flagged dirty by submit/finish events) when
        ``_queue_dirty`` is set, so a round costs O(ready) — not a
        rescan of every task of every DAG. ``legacy_scan`` keeps the old
        full-scan behaviour for baseline benchmarking; both paths promote
        tasks in the same rounds and feed strategies the same ready sets,
        so scheduling decisions are identical.
        """
        self._sched_pending = False
        self._sched_deadline = math.inf
        self.sched_rounds += 1
        if self._empty_regs or self._orphan_policy:
            self._reap_registrations(now)

        def collect_ready() -> List[Task]:
            if self.legacy_scan:
                out: List[Task] = []
                for dag in self.dags.values():
                    out.extend(dag.ready_tasks(now))
                return out
            if self._queue_dirty:
                for wid in self._dirty_dags:
                    dag = self.dags.get(wid)
                    if dag is None:
                        continue
                    for task in dag.promote_runnable(now):
                        self._ready_add(task)
                self._dirty_dags.clear()
                self._queue_dirty = False
            return list(self._ready.values())

        ready = collect_ready()
        if not ready:
            return 0
        ctx = self._context(now)
        # armed preemption pass (share/arbiter change or tenant arrival
        # since the last round, and only with max_preemptions_per_round
        # > 0): victims are killed, released through the usage-delta
        # path, and requeued *into this round's ready set* — the freed
        # capacity and the requeued work are arbitrated together below
        if self._preempt_pending and self.max_preemptions_per_round > 0:
            self._preempt_pending = False
            if self._run_preemption(ready, now, ctx):
                ready = collect_ready()
        # the arbiter interleaves per-workflow priority lists; the default
        # FirstAppearanceArbiter reproduces the pre-arbitration order
        # bit-identically (golden-trace suite pins this)
        self.arbiter_rounds += 1
        ordered = self.arbiter.order(ready, self._arbiter_context(ctx))
        launched = 0
        # per-round max_running guard (covers every arbiter; the fair-
        # share heap additionally stops emitting capped workflows): counts
        # are seeded lazily from the O(1) live-allocation view and
        # advanced per launch
        quotas = self.workflow_quotas
        quota_running: Dict[str, int] = {}
        idx = self._node_index         # None under legacy_scan
        # node views are LAZY: the live path materialises a full snapshot
        # only when an oracle (non-place_key) placement needs one, then
        # patches only the launched-on node's view after each launch;
        # indexed placements never build a view at all. legacy_scan
        # re-snapshots all N views per launch (the pre-patch cost model).
        views: Optional[List[NodeView]] = None
        view_slot: Dict[str, int] = {}
        # memory caps at the largest up-node, constant within a round —
        # O(1) from the index's churn-maintained multiset (the old
        # per-round max() scan was O(N); a regression test pins the two
        # equal across node-fail of the max-memory node)
        if idx is not None:
            mem_cap = idx.max_mem_total()
        else:
            mem_cap = max((st.info.mem_bytes for st in self.nodes.values()
                           if st.up
                           and st.info.name not in self._quarantined),
                          default=0)
        # placement feasibility index: infeasible demand buckets persist
        # until capacity can have grown (see __init__); feasible marks are
        # only valid until the next launch shrinks capacity
        if self._infeasible_version != self._capacity_version:
            self._infeasible.clear()
            self._infeasible_version = self._capacity_version
        feasible: set = set()
        for task in ordered:
            if idx is not None:
                if idx.size() == 0:
                    break
            else:
                if views is None:
                    views, view_slot = self._snapshot_views()
                    feasible = set()
                if not views:
                    break
            if quotas:
                wid = task.spec.workflow_id
                quota = quotas.get(wid)
                if quota is not None and quota.max_running is not None:
                    used = quota_running.get(wid)
                    if used is None:
                        used = self._running_count(wid)
                        quota_running[wid] = used
                    if used >= quota.max_running:
                        continue
            mem_alloc = self._memory_for(task, mem_cap)
            res = task.spec.resources
            if res.nodes > 1:
                # gang placement: all-or-nothing on k distinct nodes
                # (possibly a narrower width from the elastic ladder).
                # Entirely separate branch — nodes == 1 never reaches it.
                members = self._place_gang(task, mem_alloc)
                if members is None:
                    continue
                self._launch_gang(task, members, mem_alloc, now)
                if quotas and task.spec.workflow_id in quota_running:
                    quota_running[task.spec.workflow_id] += 1
                if self.legacy_scan:
                    views = None
                else:
                    if views is not None:
                        for member in members:
                            views[view_slot[member]] = (
                                self.nodes[member].view())
                            self.view_patches += 1
                            self.view_materializations += 1
                    feasible = set()
                launched += 1
                continue
            if not self.legacy_scan:
                key = (res.chips, res.cpus, mem_alloc)
                if key in self._infeasible:
                    continue
                if key not in feasible:
                    # watermark: O(log N) tree descent instead of the old
                    # any()-scan over all N views
                    self.feasibility_checks += 1
                    if idx.exists_fit(res.cpus, mem_alloc, res.chips):
                        feasible.add(key)
                    else:
                        self._infeasible[key] = None
                        continue
            strat = self._strategy_for(task)
            pkey: Optional[PlacementKey] = (
                strat.place_key(task, ctx) if idx is not None else None)
            if pkey is not None:
                self.placement_probes += 1
                node = self._indexed_place(pkey, res.cpus, mem_alloc,
                                           res.chips)
            else:
                if views is None:
                    # first oracle placement this round: build the full
                    # snapshot now (kept patched for later oracle calls)
                    views, view_slot = self._snapshot_views()
                if mem_alloc == res.mem_bytes:
                    probe = task
                else:
                    # strategies check fit against the *requested* allocation
                    eff = replace(task.spec, resources=replace(
                        task.spec.resources, mem_bytes=mem_alloc))
                    probe = Task(spec=eff, state=task.state,
                                 submit_time=task.submit_time)
                self.placement_probes += 1
                self.node_fit_ops += len(views)   # oracle walk cost model
                node = strat.place(probe, views, ctx)
            if node is None:
                continue
            if task.avoid_node is not None and node == task.avoid_node:
                node = self._avoid_redirect(task, node, mem_alloc, views)
            self._launch(task, node, mem_alloc, now)
            if quotas and task.spec.workflow_id in quota_running:
                quota_running[task.spec.workflow_id] += 1
            if self.legacy_scan:
                views = None
            else:
                if views is not None:
                    # patch only the launched-on node's view — the other
                    # N-1 nodes did not change (keeps a mid-round oracle
                    # snapshot coherent with the index's live state)
                    views[view_slot[node]] = self.nodes[node].view()
                    self.view_patches += 1
                    self.view_materializations += 1
                # feasible marks expire on launch: capacity only shrank
                # (the infeasible index persists for the same reason)
                feasible = set()
            launched += 1
        if self.enable_speculation:
            self.check_speculation(now)
        return launched

    def _snapshot_views(self) -> Tuple[List[NodeView], Dict[str, int]]:
        """Materialise the full up-node view snapshot (oracle placements
        and the legacy cost model) and charge the view counters."""
        views = [st.view() for st in self.nodes.values()
                 if st.up and st.info.name not in self._quarantined]
        view_slot = {v.name: i for i, v in enumerate(views)}
        self.view_snapshots += len(views)
        self.view_materializations += len(views)
        return views, view_slot

    def _avoid_redirect(self, task: Task, node: str, mem_alloc: int,
                        views: Optional[List[NodeView]]) -> str:
        """One-shot anti-affinity: the strategy picked the very node the
        task's previous launch died on. Take the first OTHER fitting
        node (registration order) instead; when only the killer fits,
        availability beats affinity and the pick stands."""
        res = task.spec.resources
        alt: Optional[str] = None
        if self._node_index is not None:
            alt = self._node_index.first_fit_slot(
                res.cpus, mem_alloc, res.chips, skip_name=node)
        elif views is not None:
            alt = next((v.name for v in views
                        if v.name != node and v.fits(task, mem_alloc)),
                       None)
        if alt is None:
            return node
        self.anti_affinity_redirects += 1
        return alt

    def _indexed_place(self, pkey: PlacementKey, cpus: float, mem: int,
                       chips: int) -> Optional[str]:
        """Resolve a declarative ``PlacementKey`` against the node index
        (bit-identical to the oracle ``place`` walk it replaces)."""
        idx = self._node_index
        if pkey.prefer:
            # locality candidates: O(#inputs) direct probes, best
            # preference first, registration order on ties (= the linear
            # scan's first-max pick among fitting candidates)
            ranked = []
            for name, weight in pkey.prefer.items():
                slot = idx.slot_of(name)
                if slot is not None:
                    ranked.append((-weight, slot, name))
            ranked.sort()
            for _, _, name in ranked:
                if idx.fit_node(name, cpus, mem, chips):
                    return name
        if pkey.ring is not None:
            return pkey.ring.pick_indexed(idx, cpus, mem, chips)
        if pkey.order is not None:
            return idx.ordered_first_fit(pkey.order, pkey.key_fn,
                                         pkey.dynamic, cpus, mem, chips)
        return None

    def _memory_for(self, task: Task, cap: Optional[int] = None) -> int:
        req = task.spec.resources.mem_bytes
        if self.mem_predictor is None or not self.use_predicted_memory:
            # paper retry rule even without the predictor: double on OOM
            alloc = req * (2 ** task.attempt)
        else:
            alloc = self.mem_predictor.allocate(
                task.name, task.spec.input_size, req, task.attempt
            )
        # never request more than the largest node can offer — a doubled
        # retry beyond cluster capacity would sit unschedulable forever
        # (callers inside a round pass the hoisted per-round cap)
        if cap is None:
            if self._node_index is not None:
                cap = (self._node_index.max_mem_total()
                       if self._node_index.size() else alloc)
            else:
                cap = max((st.info.mem_bytes for st in self.nodes.values()
                           if st.up
                           and st.info.name not in self._quarantined),
                          default=alloc)
        elif cap <= 0:
            cap = alloc
        return min(alloc, cap)

    def _launch(self, task: Task, node: str, mem_alloc: int, now: float) -> None:
        st = self.nodes[node]
        res = task.spec.resources
        cpus = res.cpus if res.chips == 0 else 0.0
        st.cpus_free -= cpus
        st.mem_free -= mem_alloc
        st.chips_free -= res.chips
        if self._node_index is not None:
            self._node_index.touch(node)
        self.allocations[task.task_id] = _Allocation(
            node, cpus, mem_alloc, res.chips, task.spec.workflow_id)
        self._charge_usage(task.task_id, task.spec.workflow_id,
                           cpus, mem_alloc, res.chips)
        self.mem_allocated[task.task_id] = mem_alloc
        self._ready_discard(task.task_id, task.spec.workflow_id)
        if self._preempt_debt:
            # the preempted work is running again: the real allocation
            # carries the charge from here (debt would double-count it)
            self._clear_preempt_debt(task.spec.workflow_id, task.task_id)
        task.launch_id = next(self._launch_seq)
        task.state = TaskState.SCHEDULED
        task.node = node
        task.schedule_time = now
        task.avoid_node = None        # the one-shot veto is spent
        if self.report_lease is not None:
            # arm the report lease (pop first: re-insertion keeps the
            # map's insertion order equal to deadline order)
            self._leases.pop(task.task_id, None)
            self._leases[task.task_id] = (task.launch_id,
                                          now + self.report_lease)
        if self.predictor is not None and self.predictor.known(task.name):
            rt, _ = self.predictor.predict(task.name, task.spec.input_size, node)
            st.est_available_at = max(st.est_available_at, now) + rt
        self.adapter.launch(task, node, mem_alloc)

    def _release(self, task_id: str) -> None:
        # every path that ends a live launch funnels through here, so
        # the lease map only ever holds live launches
        self._leases.pop(task_id, None)
        alloc = self.allocations.pop(task_id, None)
        if alloc is None:
            return
        self._discharge_usage(task_id, alloc.workflow_id)
        # a gang restores every member's per-node share; members no
        # longer in the cluster (the node-loss that killed the gang)
        # are skipped — their capacity left with them
        for member in (alloc.members or (alloc.node,)):
            st = self.nodes.get(member)
            if st is not None:
                st.cpus_free = min(st.cpus_free + alloc.cpus, st.info.cpus)
                st.mem_free = min(st.mem_free + alloc.mem,
                                  st.info.mem_bytes)
                st.chips_free = min(st.chips_free + alloc.chips,
                                    st.info.chips)
                if self._node_index is not None:
                    self._node_index.touch(member)  # no-op if node is down
        # capacity grew: previously-infeasible demand buckets may now fit
        self._capacity_version += 1

    # ------------------------------------------------------------------
    # gang placement (Resources.nodes > 1)
    # ------------------------------------------------------------------
    def _gang_sizes(self, task: Task) -> List[int]:
        """Acceptable gang widths, widest first.

        The full request leads; narrower widths come from the elastic
        ladder (``params["elastic"]["allowed"]``, validated SWMS-side
        against ``ElasticPlan.new_mesh_shape`` divisibility) so a gang
        squeezed out at full width may still run — elastic restore
        proves a (1, n)-saved checkpoint restores under (1, m)."""
        res = task.spec.resources
        sizes = [res.nodes]
        elastic = task.spec.params.get("elastic")
        if isinstance(elastic, dict):
            for width in elastic.get("allowed", ()):
                if (isinstance(width, int) and not isinstance(width, bool)
                        and 1 <= width < res.nodes and width not in sizes):
                    sizes.append(width)
        sizes.sort(reverse=True)
        return sizes

    def _place_gang(self, task: Task, mem_alloc: int) -> Optional[List[str]]:
        """Pick k distinct member nodes for a gang, or None.

        Widths are tried widest-first down the elastic ladder. Each
        width has its own infeasible bucket (keyed with the width, so
        gang buckets never collide with single-node ones) and its own
        k-node feasibility watermark. The indexed path resolves members
        through ``NodeCapacityIndex.gang_slots``; ``legacy_scan`` keeps
        the registration-order oracle walk over the node states, which
        the gang bit-identity bench pins against the tree."""
        res = task.spec.resources
        idx = self._node_index
        strat = self._strategy_for(task)
        key_fn = getattr(strat, "gang_key_fn", None)
        for width in self._gang_sizes(task):
            if idx is not None:
                key = (res.chips, res.cpus, mem_alloc, width)
                if key in self._infeasible:
                    continue
                self.feasibility_checks += 1
                if not idx.exists_gang_fit(width, res.cpus, mem_alloc,
                                           res.chips):
                    self._infeasible[key] = None
                    continue
                self.placement_probes += 1
                members = idx.gang_slots(width, res.cpus, mem_alloc,
                                         res.chips, key_fn=key_fn)
            else:
                self.placement_probes += 1
                fitting: List[Tuple[Any, int, str]] = []
                for slot, st in enumerate(self.nodes.values()):
                    if not st.up or st.info.name in self._quarantined:
                        continue
                    self.node_fit_ops += 1
                    if _fits_demand(st.cpus_free, st.mem_free,
                                    st.chips_free, res.cpus, mem_alloc,
                                    res.chips):
                        fitting.append(
                            (key_fn(st.view()) if key_fn is not None
                             else (), slot, st.info.name))
                        if key_fn is None and len(fitting) >= width:
                            break
                if len(fitting) < width:
                    members = []
                else:
                    fitting.sort()
                    members = [name for _, _, name in fitting[:width]]
            if len(members) == width:
                return members
        return None

    def _launch_gang(self, task: Task, members: List[str], mem_alloc: int,
                     now: float) -> None:
        """Atomically launch one gang across ``members``.

        The mirror of ``_launch`` with k node states decremented under
        ONE launch id and ONE allocation record — all member bookkeeping
        is written in a single pass after placement fully succeeded, so
        no failure mode can leave a partial gang behind. The adapter
        receives one launch (head node) and reads ``task.gang_nodes``
        to fan out."""
        res = task.spec.resources
        cpus = res.cpus if res.chips == 0 else 0.0
        width = len(members)
        for member in members:
            st = self.nodes[member]
            st.cpus_free -= cpus
            st.mem_free -= mem_alloc
            st.chips_free -= res.chips
            if self._node_index is not None:
                self._node_index.touch(member)
        head = members[0]
        self.allocations[task.task_id] = _Allocation(
            head, cpus, mem_alloc, res.chips, task.spec.workflow_id,
            members=tuple(members))
        # ONE task, k nodes' resources: the gang's dominant-share charge
        self._charge_usage(task.task_id, task.spec.workflow_id,
                           cpus * width, mem_alloc * width,
                           res.chips * width)
        self.mem_allocated[task.task_id] = mem_alloc
        self._ready_discard(task.task_id, task.spec.workflow_id)
        if self._preempt_debt:
            self._clear_preempt_debt(task.spec.workflow_id, task.task_id)
        task.launch_id = next(self._launch_seq)
        task.state = TaskState.SCHEDULED
        task.node = head
        task.gang_nodes = tuple(members)
        task.schedule_time = now
        task.avoid_node = None
        self.gang_launches += 1
        if width < res.nodes:
            self.gang_resizes += 1
        if self.report_lease is not None:
            # one lease covers the whole gang (one launch, one report
            # stream); size report_lease for the slowest-width runtime
            self._leases.pop(task.task_id, None)
            self._leases[task.task_id] = (task.launch_id,
                                          now + self.report_lease)
        if self.predictor is not None and self.predictor.known(task.name):
            rt, _ = self.predictor.predict(task.name, task.spec.input_size,
                                           head)
            for member in members:
                st = self.nodes[member]
                st.est_available_at = max(st.est_available_at, now) + rt
        self.adapter.launch(task, head, mem_alloc)

    def _committed_progress(self, task: Task, now: float) -> float:
        """Checkpoint-committed seconds of base runtime at kill time.

        Progress accrues at ``speed × width/requested`` base-seconds per
        wall-second (the slowest member paces a gang; a resized gang
        spreads the same work over fewer nodes) on top of what earlier
        launches already committed; only whole checkpoint intervals are
        committed — work past the last manifest is lost. Returns 0.0
        for tasks without a checkpoint cadence."""
        ckpt = task.spec.params.get("ckpt")
        if not isinstance(ckpt, dict):
            return 0.0
        interval = ckpt.get("interval_s")
        if (isinstance(interval, bool)
                or not isinstance(interval, (int, float)) or interval <= 0):
            return 0.0
        done = task.committed_s
        if task.state == TaskState.RUNNING:
            speed = 1.0
            gang = task.gang_nodes or ((task.node,) if task.node else ())
            speeds = [self.nodes[n].info.speed_factor
                      for n in gang if n in self.nodes]
            if speeds:
                speed = min(speeds)
            width = len(task.gang_nodes) or 1
            rate = speed * width / max(task.spec.resources.nodes, 1)
            done += max(now - task.start_time, 0.0) * rate
        committed = math.floor(done / interval) * interval
        base = task.spec.base_runtime_s
        if base > 0.0:
            # the last manifest that can exist is the last whole interval
            # inside the base runtime — never the base itself
            committed = min(committed, math.floor(base / interval) * interval)
        return committed

    # ------------------------------------------------------------------
    # preemptive arbitration
    # ------------------------------------------------------------------
    def _run_preemption(self, ready: List[Task], now: float,
                        ctx: SchedulingContext) -> int:
        """One armed preemption pass: consult the arbiter, apply victims.

        Candidates are live launches of real DAG tasks; speculative
        copies and their originals are excluded (that pair's lifecycle —
        first finisher wins, loser is killed — belongs to the speculation
        module, and preempting half of it would leave a phantom race).
        Returns the number of launches killed and requeued."""
        candidates: List[PreemptionCandidate] = []
        totals = self._cluster_totals()
        for tid, alloc in self.allocations.items():
            if tid in self.spec_copies or tid in self.spec_of_original:
                continue
            dag = self.dags.get(alloc.workflow_id)
            task = dag.tasks.get(tid) if dag is not None else None
            if task is None or not task.state.active:
                continue
            candidates.append(PreemptionCandidate(
                task=task,
                workflow_id=alloc.workflow_id,
                # a gang's cost is its k-node charge (what killing it
                # frees); _alloc_cost gates so single-node candidates
                # keep the exact pre-gang float
                cost=_alloc_cost(alloc, totals),
                progress=(now - task.start_time
                          if task.state == TaskState.RUNNING else 0.0),
            ))
        if not candidates:
            return 0
        # the beneficiary backlog is the ready work that CANNOT be placed
        # in current free capacity: a task that fits will launch this
        # very round without anyone dying for it, so killing on its
        # behalf would be pure churn (victim requeued and relaunched at
        # the same instant). One watermark probe per ready task, only on
        # armed passes.
        ready_counts: Dict[str, int] = {}
        idx = self._node_index
        for task in ready:
            res = task.spec.resources
            mem_alloc = self._memory_for(task)
            if res.nodes > 1:
                # a gang is unplaceable unless its NARROWEST acceptable
                # width fits — if even that fails, freeing capacity for
                # it is what preemption is for
                narrowest = min(self._gang_sizes(task))
                if idx is not None:
                    fits = idx.exists_gang_fit(narrowest, res.cpus,
                                               mem_alloc, res.chips)
                else:
                    fits = sum(
                        1 for st in self.nodes.values()
                        if st.up and st.info.name not in self._quarantined
                        and _fits_demand(st.cpus_free, st.mem_free,
                                         st.chips_free, res.cpus,
                                         mem_alloc, res.chips)
                    ) >= narrowest
            elif idx is not None:
                fits = idx.exists_fit(res.cpus, mem_alloc, res.chips)
            else:
                fits = any(
                    st.up and st.info.name not in self._quarantined
                    and _fits_demand(st.cpus_free, st.mem_free,
                                     st.chips_free, res.cpus,
                                     mem_alloc, res.chips)
                    for st in self.nodes.values())
            if not fits:
                wid = task.spec.workflow_id
                ready_counts[wid] = ready_counts.get(wid, 0) + 1
        if not ready_counts:
            return 0
        self.preempt_rounds += 1
        actx = self._arbiter_context(ctx, ready_counts=ready_counts)
        victims = self.arbiter.preempt(candidates, actx)
        # belt and braces: the bound holds even for arbiters that ignore
        # actx.max_preemptions
        for victim in victims[: self.max_preemptions_per_round]:
            self._preempt_launch(victim.task, victim.cost, now, ctx)
        return min(len(victims), self.max_preemptions_per_round)

    def _preempt_launch(self, task: Task, cost: float, now: float,
                        ctx: SchedulingContext) -> None:
        """Kill one victim launch and requeue its task.

        The allocation is released through the incremental usage-delta
        path (conservation: exactly the killed launch's demands come
        back), the lost work is charged to the victim workflow's
        preemption debt, and the launch id is burned so the dead
        launch's late start/finish reports are rejected like any other
        dead launch — id-carrying and lenient adapters alike (a requeued
        READY task has no live launch to report on)."""
        tid, wid = task.task_id, task.spec.workflow_id
        # checkpoint credit BEFORE the kill clock stops: work up to the
        # last manifest is committed — the requeued task only repeats
        # the tail past it, so its debt (what the preemption really
        # cost) shrinks by the committed fraction, and rank strategies
        # see the smaller remaining runtime (dag.touch invalidates
        # their memos). Tasks without a checkpoint cadence keep the
        # full-cost path bit-identically.
        committed = self._committed_progress(task, now)
        if committed > task.committed_s:
            task.committed_s = committed
            dag = self.dags.get(wid)
            if dag is not None:
                dag.touch()
        base = task.spec.base_runtime_s
        if task.committed_s > 0.0 and base > 0.0:
            cost *= max(base - task.committed_s, 0.0) / base
        self._release(tid)
        self.adapter.kill(tid)
        task.end_time = now
        self._record(task, "PREEMPTED",
                     TaskResult(False, reason="preempted by arbiter"))
        self._preempt_debt.setdefault(wid, {})[tid] = cost
        if task.gang_nodes:
            self.gang_preemptions += 1
        task.state = TaskState.READY
        task.node = None
        task.gang_nodes = ()
        # burn a fresh launch id NOW (as the failure/node-loss requeues
        # do): the dead launch's reports are rejected in the requeue →
        # relaunch window too
        task.launch_id = next(self._launch_seq)
        self._ready_add(task)
        self.preemptions += 1
        # requeue does not consume a retry: preemption is the engine's
        # doing, not the task's failure (attempt stays, so the memory-
        # doubling rule and max_retries are unaffected)
        self._strategy_for(task).on_task_preempted(task, ctx)

    def _clear_preempt_debt(self, wid: str, tid: str) -> None:
        entries = self._preempt_debt.get(wid)
        if entries is not None and entries.pop(tid, None) is not None:
            if not entries:
                del self._preempt_debt[wid]

    # ------------------------------------------------------------------
    # report leases + failure-domain quarantine
    # ------------------------------------------------------------------
    def lease_check(self, now: float) -> int:
        """Expire overdue report leases and release served quarantines.

        Drivers call this periodically (the simulator's LEASE_CHECK
        wakeup, an executor's poll loop). Like ``schedule_pending``, the
        no-op case is checked BEFORE the command seam so idle heartbeats
        never reach the journal; an actionable check applies a journaled
        ``LeaseCheck`` command, so replay expires the same launches at
        the same instants."""
        if not self._lease_check_due(now):
            return 0
        return self.apply(_cmd.LeaseCheck(), now)

    def _lease_check_due(self, now: float) -> bool:
        # both maps keep insertion order == deadline order, so the
        # oldest entry decides in O(1)
        for tid in self._leases:
            return self._leases[tid][1] <= now
        for name in self._quarantined:
            return self._quarantined[name] <= now
        return False

    def _apply_lease_check(self, now: float) -> int:
        expired = 0
        while self._leases:
            tid = next(iter(self._leases))
            lid, deadline = self._leases[tid]
            if deadline > now:
                break
            del self._leases[tid]
            expired += self._expire_lease(tid, lid, now)
        while self._quarantined:
            name = next(iter(self._quarantined))
            if self._quarantined[name] > now:
                break
            del self._quarantined[name]
            self._lift_quarantine(name, now)
        if expired:
            self.request_schedule(now)
        return expired

    def _expire_lease(self, tid: str, lid: int, now: float) -> int:
        """One launch produced no report inside its lease: presume the
        report (or the launch itself) lost. The launch id is burned and
        the launch killed at the adapter, so a late report is rejected
        by the stale-id / requeue-window guards; the task requeues
        without consuming a retry (silence is the transport's failure,
        not the task's)."""
        task = self._find_task(tid)
        if task is None or task.launch_id != lid or not task.state.active:
            return 0           # stale entry (defensive; _release prunes)
        self.lease_expiries += 1
        node = task.node
        result = TaskResult(
            False, reason=f"report lease expired on {node}")
        self._suspect_node(node, now)
        task.end_time = now
        if tid in self.spec_copies:
            # a silent speculative copy is not a DAG task: kill it and
            # unpair, the original keeps running
            copy = self.spec_copies.pop(tid)
            if copy.speculative_of is not None:
                self.spec_of_original.pop(copy.speculative_of, None)
            self._release(tid)
            copy.state = TaskState.KILLED
            self._record(copy, "KILLED", result)
            self.mem_allocated.pop(tid, None)
            self.adapter.kill(tid)
            return 1
        self._release(tid)
        self.adapter.kill(tid)
        self._handle_failure(task, now, result, requeue_free=True)
        return 1

    def _suspect_node(self, node: Optional[str], now: float) -> None:
        """Bump a node's suspicion score; quarantine at the threshold.

        A quarantined node leaves the capacity index (no NEW launches
        land on it) but stays ``up`` — running work continues and its
        reports are still honoured. The quarantine lifts after
        ``quarantine_duration`` via the periodic lease check."""
        if self.quarantine_threshold <= 0 or node is None:
            return
        if node not in self.nodes or node in self._quarantined:
            return
        count = self._suspicion.get(node, 0) + 1
        if count < self.quarantine_threshold:
            self._suspicion[node] = count
            return
        self._suspicion.pop(node, None)
        self._quarantined[node] = now + self.quarantine_duration
        if self._node_index is not None:
            self._node_index.remove(node)
        self._invalidate_totals()
        self._capacity_version += 1
        self.quarantines += 1
        self.provenance.record_node_event(
            NodeEvent(node, now, "QUARANTINED"))
        log.warning("node %s quarantined until %.3f", node,
                    now + self.quarantine_duration)

    def _lift_quarantine(self, name: str, now: float) -> None:
        self.quarantine_releases += 1
        st = self.nodes.get(name)
        if st is None or not st.up:
            return             # the node left the cluster meanwhile
        if self._node_index is not None:
            self._node_index.add(name, st)
        self._invalidate_totals()
        self._capacity_version += 1
        self.provenance.record_node_event(NodeEvent(name, now, "RECOVERED"))
        self.request_schedule(now)

    # ------------------------------------------------------------------
    # registration TTL
    # ------------------------------------------------------------------
    def _reap_registrations(self, now: float) -> int:
        """Reap workflows registered but never given tasks (ROADMAP
        "Future work" leak): completion-driven retirement cannot see
        them, so without a TTL one empty DAG leaks per abandoned
        registration. ``_empty_regs`` is insertion-ordered by
        registration time, so the scan stops at the first entry still
        inside the TTL — reaping is O(reaped), not O(registered).
        Tenant policy (shares, quotas, strategy overrides) reaps with
        the registration, exactly as retirement drops it: re-declare
        before re-registering the id.

        The second loop reaps *orphaned policy*: shares/quotas declared
        for wids that never registered at all (``_orphan_policy``, same
        insertion-order TTL scan). Without it every mistyped or
        abandoned pre-registration policy entry persisted forever."""
        ttl = self.registration_ttl
        if ttl is None or not (self._empty_regs or self._orphan_policy):
            return 0
        reaped = 0
        while self._empty_regs:
            wid = next(iter(self._empty_regs))
            if now - self._empty_regs[wid] < ttl:
                break
            del self._empty_regs[wid]
            dag = self.dags.get(wid)
            if dag is not None and not dag.tasks:
                del self.dags[wid]
                self._dirty_dags.pop(wid, None)
                self._unfinished.pop(wid, None)
                self._evict_workflow_caches(wid)
                self.workflow_strategies.pop(wid, None)
                self.workflow_shares.pop(wid, None)
                self.workflow_quotas.pop(wid, None)
                self._preempt_debt.pop(wid, None)
                reaped += 1
        self.reaped_registrations += reaped
        reaped_policies = 0
        while self._orphan_policy:
            wid = next(iter(self._orphan_policy))
            if now - self._orphan_policy[wid] < ttl:
                break
            del self._orphan_policy[wid]
            if wid in self.dags:
                continue       # registered since: retirement owns it now
            self.workflow_shares.pop(wid, None)
            self.workflow_quotas.pop(wid, None)
            reaped_policies += 1
        self.reaped_policies += reaped_policies
        return reaped + reaped_policies

    # ------------------------------------------------------------------
    # completion paths
    # ------------------------------------------------------------------
    def _record(self, task: Task, state: str, result: TaskResult) -> None:
        self.provenance.record_task(TaskTrace(
            workflow_id=task.spec.workflow_id,
            task_id=task.task_id,
            name=task.name,
            attempt=task.attempt,
            node=task.node,
            submit_time=task.submit_time,
            schedule_time=task.schedule_time,
            start_time=task.start_time,
            end_time=task.end_time,
            state=state,
            input_size=task.spec.input_size,
            output_size=sum(o.size_bytes for o in task.spec.outputs),
            cpu_seconds=result.cpu_seconds,
            peak_mem_bytes=result.peak_mem_bytes,
            requested_mem_bytes=self.mem_allocated.get(task.task_id, 0),
            chips=task.spec.resources.chips,
            failure_reason=result.reason,
        ))

    def _finish_success(self, task: Task, now: float, result: TaskResult) -> None:
        task.state = TaskState.SUCCEEDED
        self.tasks_settled += 1
        # a task can be credited by a winning speculative copy while its
        # requeued original still sits READY and unplaced — drop it from
        # the queue or it would be launched again after succeeding
        self._ready_discard(task.task_id, task.spec.workflow_id)
        if self._preempt_debt:
            # settled without a relaunch (e.g. a copy's win): drop debt
            self._clear_preempt_debt(task.spec.workflow_id, task.task_id)
        self._record(task, "SUCCEEDED", result)
        self.mem_allocated.pop(task.task_id, None)
        # outputs become resident on the executing node (data locality)
        task.spec.outputs = tuple(
            DataRef(o.name, o.size_bytes, task.node) for o in task.spec.outputs
        )
        self._propagate_locations(task)
        # online learning (paper §5): feed predictors from the completion
        if self.predictor is not None and task.runtime_s > 0:
            self.predictor.observe(
                task.name, task.spec.input_size, task.runtime_s, task.node
            )
        if self.mem_predictor is not None and result.peak_mem_bytes > 0:
            self.mem_predictor.observe(
                task.name, task.spec.input_size, result.peak_mem_bytes
            )
        self._strategy_for(task).on_task_finished(task, self._context(now))
        # a successful original kills its speculative copy and vice versa
        copy_id = self.spec_of_original.pop(task.task_id, None)
        if copy_id is not None:
            copy = self.spec_copies.pop(copy_id, None)
            if copy is not None and not copy.state.terminal:
                copy.state = TaskState.KILLED
                self._release(copy_id)
                self.mem_allocated.pop(copy_id, None)
                self.adapter.kill(copy_id)
        dag = self.dags[task.spec.workflow_id]
        if dag.on_task_succeeded(task.task_id):
            self._mark_dirty(dag.workflow_id)
        if dag.finished():
            self._unfinished.pop(dag.workflow_id, None)
            self._evict_workflow_caches(dag.workflow_id)
            if self.on_workflow_done is not None:
                self.on_workflow_done(dag.workflow_id)
            self._retire_workflow(dag, now)

    def _propagate_locations(self, task: Task) -> None:
        """Children's matching inputs inherit the producing node (for HEFT's
        staging term and data-aware placement)."""
        dag = self.dags[task.spec.workflow_id]
        outs = {o.name: o for o in task.spec.outputs}
        if not outs:
            return
        for child_id in dag.children[task.task_id]:
            child = dag.tasks[child_id]
            child.spec.inputs = tuple(
                outs.get(i.name, i) for i in child.spec.inputs
            )
        # input specs changed in place: invalidate strategy memos
        dag.touch()

    def _handle_failure(self, task: Task, now: float, result: TaskResult,
                        requeue_free: bool = False) -> None:
        self._record(task, "FAILED", result)
        failed_on = task.node
        if requeue_free:
            # engine-initiated requeue (node loss, lease expiry): the
            # checkpoint manifest lives off-node, so progress committed
            # up to the last manifest survives into the relaunch
            committed = self._committed_progress(task, now)
            if committed > task.committed_s:
                task.committed_s = committed
                dag = self.dags.get(task.spec.workflow_id)
                if dag is not None:
                    dag.touch()
        else:
            # a real failure on a live node counts against it (requeue-
            # free paths are the engine's doing — node loss bumps
            # nothing, lease expiry scores its node itself)
            self._suspect_node(failed_on, now)
            task.attempt += 1
            # a crashing task may have corrupted its checkpoint stream:
            # the retry restarts from zero (preemption never does this)
            task.committed_s = 0.0
        if task.attempt > task.spec.max_retries:
            task.state = TaskState.ERROR
            self.tasks_settled += 1
            task.failure_reason = result.reason
            self.mem_allocated.pop(task.task_id, None)
            self._ready_discard(task.task_id, task.spec.workflow_id)
            if self._preempt_debt:
                self._clear_preempt_debt(task.spec.workflow_id, task.task_id)
            log.warning("task %s permanently failed: %s", task.task_id, result.reason)
            dag = self.dags[task.spec.workflow_id]
            dag.on_task_error(task.task_id)
            # terminal-failure propagation: every descendant still holds
            # an unmet dependency on this task, so each is provably
            # PENDING — cancel them now or the workflow wedges with
            # ``finished()`` forever counting them as unterminated
            for cid in dag.cancel_descendants(task.task_id):
                child = dag.tasks[cid]
                child.end_time = now
                self.tasks_settled += 1
                self._record(child, "CANCELLED",
                             TaskResult(False, reason=child.failure_reason))
            if dag.finished():
                self._unfinished.pop(dag.workflow_id, None)
                self._evict_workflow_caches(dag.workflow_id)
                if self.on_workflow_done is not None:
                    self.on_workflow_done(dag.workflow_id)
                self._retire_workflow(dag, now)
            return
        if self.retry_anti_affinity and failed_on is not None:
            # one-shot veto: steer the retry off the node that just
            # killed it (spent at the next launch, honoured or not)
            task.avoid_node = failed_on
        task.state = TaskState.READY
        task.node = None
        task.gang_nodes = ()
        task.failure_reason = result.reason
        # the old launch is dead the moment the task is requeued: burn a
        # fresh launch id NOW so the dead launch's late reports are
        # rejected in the requeue→relaunch window too, not only after
        # the relaunch stamps its own id
        task.launch_id = next(self._launch_seq)
        # retry: straight back onto the ready queue (ready_time unchanged)
        self._ready_add(task)

    # ------------------------------------------------------------------
    # straggler mitigation: speculative execution
    # ------------------------------------------------------------------
    def check_speculation(self, now: float) -> int:
        """Launch backup copies of tasks running far beyond their prediction."""
        if self.predictor is None:
            return 0
        launched = 0
        for tid, alloc in list(self.allocations.items()):
            if tid in self.spec_copies or tid in self.spec_of_original:
                continue
            task = self._find_task(tid)
            if task is None or task.state != TaskState.RUNNING:
                continue
            if task.spec.resources.nodes > 1:
                # a backup copy of a gang would hold k more nodes for a
                # race the checkpoint stream already mitigates
                continue
            if not self.predictor.known(task.name):
                continue
            rt, std = self.predictor.predict(task.name, task.spec.input_size, alloc.node)
            elapsed = now - task.start_time
            threshold = max(self.speculation_min_runtime,
                            self.speculation_factor * (rt + std))
            if elapsed < threshold:
                continue
            quota = self.workflow_quotas.get(task.spec.workflow_id)
            if (quota is not None and quota.max_running is not None
                    and self._running_count(task.spec.workflow_id)
                    >= quota.max_running):
                # a backup copy is a second live allocation for the same
                # tenant: it honours max_running like any launch
                continue
            copy_id = fresh_task_id(f"spec-{task.task_id}")
            copy_spec = replace(task.spec, task_id=copy_id)
            copy = Task(spec=copy_spec, state=TaskState.READY,
                        submit_time=now, speculative_of=tid)
            mem_alloc = self.mem_allocated.get(tid, task.spec.resources.mem_bytes)
            res = copy.spec.resources
            if self._node_index is not None:
                # first fitting node in registration order, excluding the
                # straggler's own node — the indexed twin of the old
                # filtered-views walk (bit-identical pick)
                target = self._node_index.first_fit_slot(
                    res.cpus, mem_alloc, res.chips, skip_name=alloc.node)
            else:
                views = [st.view() for st in self.nodes.values()
                         if st.up and st.info.name != alloc.node
                         and st.info.name not in self._quarantined]
                self.view_materializations += len(views)
                self.node_fit_ops += len(views)   # same cost model as the
                # oracle placement walk, so legacy-vs-indexed node_fit_ops
                # ratios stay comparable when speculation is on
                target = next(
                    (v.name for v in views if v.fits(copy, mem_alloc)), None)
            if target is None:
                continue
            self.spec_copies[copy_id] = copy
            self.spec_of_original[tid] = copy_id
            self._launch(copy, target, mem_alloc, now)
            launched += 1
            log.info("speculative copy %s of %s on %s", copy_id, tid, target)
        return launched

    def _finish_speculative_copy(self, copy: Task, now: float,
                                 result: TaskResult) -> None:
        orig_id = copy.speculative_of
        self.spec_copies.pop(copy.task_id, None)
        if orig_id is not None:
            self.spec_of_original.pop(orig_id, None)
        if not result.success or orig_id is None:
            copy.state = TaskState.FAILED
            self._record(copy, "FAILED", result)
            self.mem_allocated.pop(copy.task_id, None)
            return
        orig = self._find_task(orig_id)
        if orig is None or orig.state.terminal:
            copy.state = TaskState.KILLED      # lost the race
            self._record(copy, "KILLED", result)
            self.mem_allocated.pop(copy.task_id, None)
            return
        # copy won: kill the straggling original, credit the workflow task
        copy.state = TaskState.SUCCEEDED
        self._record(copy, "SUCCEEDED", result)
        self.mem_allocated.pop(copy.task_id, None)
        self._release(orig_id)
        self.adapter.kill(orig_id)
        orig.node = copy.node
        orig.start_time = copy.start_time
        orig.end_time = now
        self._finish_success(orig, now, result)

    # ------------------------------------------------------------------
    def _find_task(self, task_id: str) -> Optional[Task]:
        if task_id in self.spec_copies:
            return self.spec_copies[task_id]
        for dag in self.dags.values():
            if task_id in dag:
                return dag.task(task_id)
        return None

    def stats(self) -> Dict[str, Any]:
        return {
            "strategy": self.strategy.name,
            "workflow_strategies": {
                w: s.name for w, s in self.workflow_strategies.items()
            },
            "arbiter": self.arbiter.name,
            "workflow_shares": dict(self.workflow_shares),
            "workflow_quotas": {
                wid: {"maxRunning": q.max_running, "maxQueued": q.max_queued}
                for wid, q in self.workflow_quotas.items()
            },
            "preemptions": self.preemptions,
            "max_preemptions_per_round": self.max_preemptions_per_round,
            "reaped_registrations": self.reaped_registrations,
            "reaped_policies": self.reaped_policies,
            "journaled": self.journal is not None,
            "nodes": {n: s.up for n, s in self.nodes.items()},
            "workflows": {w: d.finished() for w, d in self.dags.items()},
            "running": len(self.allocations),
            "ready": len(self._ready),
            "retired": len(self._retired),
            "indexed_nodes": (self._node_index.size()
                              if self._node_index is not None else 0),
            "placement_probes": self.placement_probes,
            "arbiter_rounds": self.arbiter_rounds,
            "sync_schedule": self.sync_schedule,
            "schedule_pending": self._sched_pending,
            "decision_lag": self.decision_lag,
            "tasks_settled": self.tasks_settled,
            "unfinished_workflows": len(self._unfinished),
            "report_lease": self.report_lease,
            "live_leases": len(self._leases),
            "lease_expiries": self.lease_expiries,
            "quarantined_nodes": sorted(self._quarantined),
            "quarantines": self.quarantines,
            "quarantine_releases": self.quarantine_releases,
            "anti_affinity_redirects": self.anti_affinity_redirects,
            "duplicate_requests": self.duplicate_requests,
            "dedup_window_size": len(self._seen_requests),
            "gang_launches": self.gang_launches,
            "gang_resizes": self.gang_resizes,
            "gang_preemptions": self.gang_preemptions,
        }

    def op_counts(self) -> Dict[str, int]:
        """Scheduling-overhead counters (see bench_sched_scale.py)."""
        return {
            "rounds": self.sched_rounds,
            "sched_round_events": self.sched_round_events,
            "readiness_ops": self._retired_readiness_ops + sum(
                d.readiness_ops for d in self.dags.values()),
            "rank_ops": self._retired_rank_ops + sum(
                d.rank_ops for d in self.dags.values()),
            "placement_probes": self.placement_probes,
            "feasibility_checks": self.feasibility_checks,
            "arbiter_rounds": self.arbiter_rounds,
            "usage_delta_ops": self.usage_delta_ops,
            "usage_scan_ops": self.usage_scan_ops,
            "view_snapshots": self.view_snapshots,
            "view_patches": self.view_patches,
            "view_materializations": self.view_materializations,
            "node_fit_ops": self.node_fit_ops + (
                self._node_index.node_fit_ops
                if self._node_index is not None else 0),
            "index_updates": (self._node_index.index_updates
                              if self._node_index is not None else 0),
            "priority_sorts": self.priority_sorts,
            "priority_cache_hits": self.priority_cache_hits,
            "preemptions": self.preemptions,
            "preempt_rounds": self.preempt_rounds,
            "preempt_triggers": self.preempt_triggers,
            "reaped_registrations": self.reaped_registrations,
            "reaped_policies": self.reaped_policies,
            "tasks_settled": self.tasks_settled,
            "unfinished_workflows": len(self._unfinished),
            "lease_expiries": self.lease_expiries,
            "quarantines": self.quarantines,
            "quarantine_releases": self.quarantine_releases,
            "anti_affinity_redirects": self.anti_affinity_redirects,
            "duplicate_requests": self.duplicate_requests,
            "gang_launches": self.gang_launches,
            "gang_resizes": self.gang_resizes,
            "gang_preemptions": self.gang_preemptions,
        }
