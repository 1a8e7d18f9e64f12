"""Scheduling strategies for the Common Workflow Scheduler.

``Original`` reproduces the baseline the paper measures against (the plain
SWMS→Kubernetes interaction: FIFO submission order, workflow-blind spread
placement). ``RankStrategy("min")`` is the paper's headline **Rank (Min)
Round Robin**. ``HEFT`` and ``Tarema`` are the §5 "advanced resource
management" integrations, fed by the prediction plugins.

A strategy answers two questions, and only these two:
  * ``prioritize(ready_tasks, ctx)`` — in which order should ready tasks grab
    resources?
  * ``place(task, nodes, ctx)``      — which node/slice should a task run on
    (or ``None`` → leave queued)?
The engine (scheduler.py) owns everything else: state machines, retries,
resource accounting, speculation.

Both questions have a *declarative* fast path. ``priority_key`` /
``priority_token`` let the engine cache each workflow's sorted ready
queue instead of re-sorting per round; ``place_key`` (its placement
twin) lets the engine resolve placement against the node-capacity index
(``node_index.py``) in O(log N) instead of scanning all N node views.
``place(task, views, ctx)`` remains the oracle: custom strategies that
declare no ``place_key``, strategies whose score is task-dependent
(warm HEFT's EFT, Tarema's grouping), and ``legacy_scan=True`` engines
all walk the full snapshot exactly as before — and the indexed path is
pinned bit-identical to that walk by the golden traces and the
``tests/test_node_index.py`` oracle suite.
"""
from __future__ import annotations

import itertools
from abc import ABC, abstractmethod
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, TYPE_CHECKING

from .dag import Task, WorkflowDAG
from .node_index import fits_demand as _fits_demand

if TYPE_CHECKING:  # pragma: no cover
    from .predict import FeedbackMemoryPredictor, LotaruPredictor
    from .provenance import ProvenanceStore


@dataclass
class NodeView:
    """What a strategy may know about a node (read-only snapshot)."""

    name: str
    cpus_total: float
    mem_total: int
    cpus_free: float
    mem_free: int
    chips_total: int = 0
    chips_free: int = 0
    speed_factor: float = 1.0
    labels: Dict[str, str] = field(default_factory=dict)
    # engine-maintained estimate of when currently-running work drains:
    est_available_at: float = 0.0

    def fits(self, task: Task, mem_alloc: Optional[int] = None) -> bool:
        res = task.spec.resources
        mem = mem_alloc if mem_alloc is not None else res.mem_bytes
        return self.fits_demand(res.cpus, mem, res.chips)

    def fits_demand(self, cpus: float, mem: int, chips: int) -> bool:
        """Raw demand-signature fit — delegates to the single shared
        admission rule (``node_index.fits_demand``), which the capacity
        index's probes and tree pruning also use, so the oracle and
        indexed placement paths can never disagree on what "fits"."""
        return _fits_demand(self.cpus_free, self.mem_free, self.chips_free,
                            cpus, mem, chips)


@dataclass
class SchedulingContext:
    dags: Dict[str, WorkflowDAG]
    provenance: "ProvenanceStore"
    predictor: Optional["LotaruPredictor"] = None
    mem_predictor: Optional["FeedbackMemoryPredictor"] = None
    now: float = 0.0
    # bytes/s assumed for staging inputs across nodes (HEFT comm term);
    # the TPU adaptation sets this to the DCN bandwidth between pods.
    staging_bandwidth: float = 1e9

    def dag_of(self, task: Task) -> WorkflowDAG:
        return self.dags[task.spec.workflow_id]


@dataclass
class PlacementKey:
    """Declarative placement: how to resolve ``place`` via the node index.

    Returned by ``Strategy.place_key`` (``None`` → the engine falls back
    to the ``place(task, views, ctx)`` oracle over a full node-view
    snapshot). Exactly one placement mode applies, tried in order:

    * ``prefer`` — node-name → preference-weight candidates probed first,
      in (descending weight, registration order); used for data locality,
      where the candidate set is O(#inputs), not O(N). Falls through to
      ``ring``/``order`` when no candidate fits.
    * ``ring`` — the paper's stateful round-robin: the placer walks the
      index's name-sorted ring from its persistent pointer (O(log N)
      instead of rebuilding an O(N) name→view map per pick).
    * ``order`` + ``key_fn`` — score-based placement: the index keeps the
      up-nodes sorted by ``(key_fn(node), registration slot)`` and returns
      the first *fitting* entry, which is ``max(fit, key=score)`` of the
      linear scan including Python's first-on-tie semantics. ``order``
      names the key's semantics (the structure is shared across strategy
      instances), so ``key_fn`` must be a module-level pure function of
      the node's capacity fields; ``dynamic=False`` marks keys that read
      only static attributes (e.g. speed factor), which skip the
      per-launch re-seating entirely.
    """

    order: Optional[str] = None
    key_fn: Optional[Callable[[Any], tuple]] = None
    dynamic: bool = True
    ring: Optional["_RoundRobinPlacer"] = None
    prefer: Optional[Dict[str, float]] = None


# Module-level place keys (shared index structures; smaller = preferred,
# ties broken by node registration order — the linear scan's first pick).
def _spread_place_key(n: Any) -> tuple:
    """LeastAllocated spread: maximise normalised free cpu+mem
    (OriginalStrategy's kube-like score, negated for min-order)."""
    return (-(n.cpus_free / max(n.cpus_total, 1e-9)
              + n.mem_free / max(n.mem_total, 1)),)


def _speed_place_key(n: Any) -> tuple:
    """Fastest node first (HEFT's cold-predictor fallback)."""
    return (-n.speed_factor,)


def _pack_place_key(n: Any) -> tuple:
    """Best fit: tightest node first (chips, then cpus, then memory)."""
    return (n.chips_free, n.cpus_free, n.mem_free)


def _unpack_place_key(n: Any) -> tuple:
    """Worst fit: roomiest node first (negated best-fit key)."""
    return (-n.chips_free, -n.cpus_free, -n.mem_free)


class Strategy(ABC):
    name: str = "abstract"

    @abstractmethod
    def prioritize(self, tasks: List[Task], ctx: SchedulingContext) -> List[Task]:
        ...

    @abstractmethod
    def place(self, task: Task, nodes: List[NodeView],
              ctx: SchedulingContext) -> Optional[str]:
        ...

    # ------------------------------------------------------------------
    # indexed placement (the engine's node-capacity index)
    # ------------------------------------------------------------------
    # A strategy whose place() is "first fitting node in some node order"
    # may declare that order here; the engine then resolves placement
    # through the O(log N) node index instead of materialising all N
    # node views and walking them. ``None`` (the default) means "not
    # indexable for this task": place() is called with a full snapshot,
    # preserving the behaviour of task-dependent scorers (warm HEFT,
    # Tarema) and of any out-of-tree subclass that predates the hook.
    # The engine may call this per task per round — return prebuilt
    # specs, not fresh allocations, unless the spec is task-dependent.
    def place_key(self, task: Task,
                  ctx: SchedulingContext) -> Optional[PlacementKey]:
        return None

    # hook for strategies that learn from completions (e.g. Tarema labels)
    def on_task_finished(self, task: Task, ctx: SchedulingContext) -> None:
        pass

    # hook for strategies that cache placement/ordering state keyed to a
    # task's *launch* — called when the engine preempts (kills + requeues)
    # a running launch under preemptive arbitration. The built-ins need
    # no action: rank/HEFT memos key on DAG/predictor versions (the DAG
    # is unchanged by a requeue) and the engine's cached priority queues
    # are invalidated by the requeue's ready-membership bump; out-of-tree
    # strategies tracking in-flight launches override this to stay
    # coherent.
    def on_task_preempted(self, task: Task, ctx: SchedulingContext) -> None:
        pass

    # hook for strategies that cache per-workflow state (e.g. HEFT's rank
    # memo): called when a workflow completes or is replaced, so caches do
    # not accumulate one entry per workflow ever scheduled
    def on_workflow_done(self, workflow_id: str) -> None:
        pass

    # ------------------------------------------------------------------
    # cacheable priorities (the engine's per-workflow order cache)
    # ------------------------------------------------------------------
    # A strategy whose prioritize() is ``sorted(tasks, key=priority_key)``
    # with a key that is a pure function of (task, token) may declare it
    # here; the engine then caches each workflow's sorted ready queue and
    # only re-sorts when the token (e.g. the DAG version) or the queue
    # membership changes, instead of re-sorting the whole ready set every
    # scheduling round. ``None`` (the default) means "not cacheable":
    # prioritize() is called fresh each round, preserving the behaviour of
    # strategies with round-varying keys (e.g. FairStrategy) and of any
    # out-of-tree subclass that predates these hooks.
    def priority_token(self, ctx: SchedulingContext,
                       dag: Optional[WorkflowDAG]) -> Optional[tuple]:
        return None

    def priority_key(self, task: Task, ctx: SchedulingContext) -> tuple:
        raise NotImplementedError(
            f"{self.name} declares no cacheable priority key")

    def _prioritize_by_key(self, tasks: List[Task],
                           ctx: SchedulingContext) -> List[Task]:
        """Shared prioritize() body for key-declaring strategies, so the
        cached (engine) and fresh (this) paths sort by the SAME key —
        divergence between the two would change decisions only on
        cache-warm rounds."""
        keyed = [(self.priority_key(t, ctx), t) for t in tasks]
        keyed.sort(key=lambda kv: kv[0])
        return [t for _, t in keyed]


# ---------------------------------------------------------------------------
# placement helpers
# ---------------------------------------------------------------------------
def _fitting(task: Task, nodes: Sequence[NodeView]) -> List[NodeView]:
    return [n for n in nodes if n.fits(task)]


class _RoundRobinPlacer:
    """Stateful round-robin over node names (the paper's 'Round Robin'):
    a persistent pointer walks a fixed node ring and advances to the next
    node that fits — stable under churn in the fitting set.

    The ring is persistent: it is re-sorted only when the node *membership*
    actually changes (detected by a cheap length + set-lookup scan, so node
    add/remove is the only event that pays the sort), not on every ``pick``
    as the pre-index placer did. The resync applies ``ptr %= len`` exactly
    when the old lazy re-sort would have, keeping decisions bit-identical
    under node churn. Fit checks walk the ring lazily from the pointer, so
    a pick usually costs O(1) fits instead of O(nodes)."""

    def __init__(self) -> None:
        self._ring: List[str] = []
        self._members: frozenset = frozenset()
        self._ptr = 0
        # index membership version this placer last resynced at (the
        # indexed twin of the oracle walk's membership-diff check)
        self._ring_version = -1

    def pick_indexed(self, index: Any, cpus: float, mem: int,
                     chips: int) -> Optional[str]:
        """The pick() walk, resolved against the node-capacity index.

        Same persistent ring and pointer; the first fitting node from
        the pointer is found by O(log N) tree descent instead of an
        O(N) name→view dict build plus lazy walk. Resync applies
        ``ptr %= len`` exactly when the oracle walk would (membership
        changed since this placer last looked), so decisions stay
        bit-identical — the oracle-vs-indexed unit test pins this.
        """
        names, version = index.ring()
        if self._ring_version != version:
            self._ring = list(names)
            self._members = frozenset(names)
            self._ptr %= max(len(names), 1)
            self._ring_version = version
        n = len(names)
        if n == 0:
            return None
        pos = index.ring_first_fit(self._ptr, cpus, mem, chips)
        if pos is None:
            return None
        self._ptr = (pos + 1) % n
        return names[pos]

    def pick(self, task: Task, nodes: Sequence[NodeView]) -> Optional[str]:
        if len(nodes) != len(self._ring) or any(
                n.name not in self._members for n in nodes):
            self._ring = sorted(n.name for n in nodes)
            self._members = frozenset(self._ring)
            self._ptr %= max(len(self._ring), 1)
        if not self._ring:
            return None
        by_name = {n.name: n for n in nodes}
        for i in range(len(self._ring)):
            cand = self._ring[(self._ptr + i) % len(self._ring)]
            if by_name[cand].fits(task):
                self._ptr = (self._ptr + i + 1) % len(self._ring)
                return cand
        return None


# ---------------------------------------------------------------------------
# Original: the workflow-blind baseline (Fig. 2 "Original strategy")
# ---------------------------------------------------------------------------
class OriginalStrategy(Strategy):
    """FIFO order; k8s-default-like placement: spread to the node with the
    most free resources. No DAG knowledge whatsoever."""

    name = "original"

    _PLACE_KEY = PlacementKey(order="spread", key_fn=_spread_place_key)

    def prioritize(self, tasks: List[Task], ctx: SchedulingContext) -> List[Task]:
        return self._prioritize_by_key(tasks, ctx)

    def priority_token(self, ctx, dag):
        return ()               # FIFO keys are static once a task is ready

    def priority_key(self, task: Task, ctx: SchedulingContext) -> tuple:
        return (task.ready_time, task.submit_time, task.task_id)

    def place_key(self, task, ctx):
        return self._PLACE_KEY

    def place(self, task: Task, nodes: List[NodeView],
              ctx: SchedulingContext) -> Optional[str]:
        fit = _fitting(task, nodes)
        if not fit:
            return None
        # "LeastAllocated" spread scoring, as the default kube-scheduler
        # does — the SAME key function the index sorts by (min of the
        # negated score ≡ max of the score, first-on-tie either way), so
        # the oracle and indexed paths cannot drift apart.
        return min(fit, key=_spread_place_key).name


class FIFORoundRobin(Strategy):
    """FIFO + round-robin placement (ablation between Original and Rank)."""

    name = "fifo_rr"

    def __init__(self) -> None:
        self._rr = _RoundRobinPlacer()
        self._place_key = PlacementKey(ring=self._rr)

    def prioritize(self, tasks: List[Task], ctx: SchedulingContext) -> List[Task]:
        return self._prioritize_by_key(tasks, ctx)

    def priority_token(self, ctx, dag):
        return ()

    def priority_key(self, task: Task, ctx: SchedulingContext) -> tuple:
        return (task.ready_time, task.submit_time, task.task_id)

    def place_key(self, task, ctx):
        return self._place_key

    def place(self, task, nodes, ctx):
        return self._rr.pick(task, nodes)


# ---------------------------------------------------------------------------
# Rank strategies — the paper's contribution class. Rank (Min) Round Robin is
# the headline configuration (median improvement up to 24.8%, avg 10.8%).
# ---------------------------------------------------------------------------
class RankStrategy(Strategy):
    """Order ready tasks by DAG upward rank (longest path to a sink), i.e.
    push the critical path first; ties broken by input size (``min`` → small
    inputs first, ``max`` → large first). Placement: round robin."""

    def __init__(self, tie: str = "min") -> None:
        assert tie in ("min", "max")
        self.tie = tie
        self.name = f"rank_{tie}_rr"
        self._rr = _RoundRobinPlacer()
        self._place_key = PlacementKey(ring=self._rr)

    def prioritize(self, tasks: List[Task], ctx: SchedulingContext) -> List[Task]:
        return self._prioritize_by_key(tasks, ctx)

    def priority_token(self, ctx, dag):
        # ranks and input sizes only move when the DAG mutates (edges,
        # in-place input relocation → touch()), all covered by its version
        return None if dag is None else (dag.version,)

    def priority_key(self, task: Task, ctx: SchedulingContext) -> tuple:
        rank = ctx.dag_of(task).ranks()[task.task_id]
        size = task.spec.input_size
        tie = size if self.tie == "min" else -size
        return (-rank, tie, task.ready_time, task.task_id)

    def place_key(self, task, ctx):
        return self._place_key

    def place(self, task, nodes, ctx):
        return self._rr.pick(task, nodes)


# ---------------------------------------------------------------------------
# HEFT (dynamic variant) — predictor-fed (§5 "Workflow Task Scheduling")
# ---------------------------------------------------------------------------
class HEFTStrategy(Strategy):
    """Upward ranks weighted by *predicted* runtimes; placement minimises
    Earliest Finish Time using per-node speed factors, the engine's
    node-drain estimates, and an input-staging term. Falls back to unit
    weights while the predictor is cold (making it ≈ RankStrategy).

    Weighted ranks are memoised per workflow, keyed on the DAG's and the
    predictor's version counters: one O(V+E) recompute when either learns
    something new, instead of one per ready task per round. With the memo
    warm, ``prioritize`` is O(ready·log ready)."""

    name = "heft"

    def __init__(self, memo: bool = True) -> None:
        self._memo_enabled = memo
        # wid -> ((dag.version, predictor.version), ranks); evicted via
        # on_workflow_done so a long-lived scheduler does not accumulate
        # one ranks dict per workflow ever scheduled
        self._memo: Dict[str, tuple] = {}

    def on_workflow_done(self, workflow_id: str) -> None:
        self._memo.pop(workflow_id, None)

    def _weighted_ranks(self, dag: WorkflowDAG,
                        ctx: SchedulingContext) -> Dict[str, float]:
        key = (dag.version, ctx.predictor.version)
        if self._memo_enabled:
            hit = self._memo.get(dag.workflow_id)
            if hit is not None and hit[0] == key:
                return hit[1]
        weights = {
            tid: (
                ctx.predictor.predict(dag.tasks[tid].name,
                                      dag.tasks[tid].spec.input_size)[0]
                if ctx.predictor.known(dag.tasks[tid].name)
                else 1.0
            )
            for tid in dag.tasks
        }
        # checkpoint credit: a preempted task resumes from its last
        # committed checkpoint, so only the *remaining* work should pull
        # its upward rank (committed_s bumps dag.version via touch(), so
        # the memo key already covers this)
        for tid, t in dag.tasks.items():
            base = t.spec.base_runtime_s
            if t.committed_s > 0.0 and base > 0.0:
                weights[tid] *= max(base - t.committed_s, 0.0) / base
        ranks = dag.ranks(weights)
        if self._memo_enabled:
            self._memo[dag.workflow_id] = (key, ranks)
        return ranks

    def prioritize(self, tasks: List[Task], ctx: SchedulingContext) -> List[Task]:
        return self._prioritize_by_key(tasks, ctx)

    def priority_token(self, ctx, dag):
        if dag is None:
            return None
        if ctx.predictor is None:       # RankStrategy("min") fallback path
            return (0, dag.version)
        return (1, dag.version, ctx.predictor.version)

    def priority_key(self, task: Task, ctx: SchedulingContext) -> tuple:
        if ctx.predictor is None:
            rank = ctx.dag_of(task).ranks()[task.task_id]
            return (-rank, task.spec.input_size, task.ready_time, task.task_id)
        rank = self._weighted_ranks(ctx.dag_of(task), ctx)[task.task_id]
        return (-rank, task.ready_time, task.task_id)

    _COLD_PLACE_KEY = PlacementKey(order="speed", key_fn=_speed_place_key,
                                   dynamic=False)

    def place_key(self, task, ctx):
        # cold predictor → fastest-node placement is a static node order;
        # warm EFT scores are task-dependent (staging + drain estimates),
        # so those placements stay on the full-snapshot oracle
        if ctx.predictor is None or not ctx.predictor.known(task.name):
            return self._COLD_PLACE_KEY
        return None

    def place(self, task: Task, nodes: List[NodeView],
              ctx: SchedulingContext) -> Optional[str]:
        fit = _fitting(task, nodes)
        if not fit:
            return None
        if ctx.predictor is None or not ctx.predictor.known(task.name):
            # shared key fn with the indexed cold path (see place_key)
            return min(fit, key=_speed_place_key).name

        def eft(n: NodeView) -> float:
            rt, _ = ctx.predictor.predict(task.name, task.spec.input_size, n.name)
            # staging: inputs not already resident on n travel over the wire
            remote = sum(
                r.size_bytes for r in task.spec.inputs
                if r.location is not None and r.location != n.name
            )
            start = max(ctx.now, n.est_available_at)
            return start + remote / ctx.staging_bandwidth + rt

        return min(fit, key=eft).name


# ---------------------------------------------------------------------------
# Tarema — node labeling + task labeling (Bader et al., BigData'21)
# ---------------------------------------------------------------------------
class TaremaStrategy(Strategy):
    """Groups nodes into performance labels from their benchmark scores and
    task types into demand labels from observed resource usage; high-demand
    task groups are steered to high-performance node groups. Requires no
    runtime estimates — only relative usage — matching the paper's framing.
    """

    name = "tarema"

    def __init__(self, n_groups: int = 3) -> None:
        self.n_groups = n_groups
        self._task_stats: Dict[str, List[float]] = {}

    # -- labelling --
    def _node_groups(self, nodes: List[NodeView]) -> Dict[str, int]:
        """Quantile-bucket nodes by speed factor → group 0 (slow) .. k-1."""
        spd = sorted(set(n.speed_factor for n in nodes))
        if len(spd) <= 1:
            return {n.name: 0 for n in nodes}
        buckets = min(self.n_groups, len(spd))
        bounds = [spd[int(len(spd) * (i + 1) / buckets) - 1] for i in range(buckets)]
        out = {}
        for n in nodes:
            for g, b in enumerate(bounds):
                if n.speed_factor <= b + 1e-12:
                    out[n.name] = g
                    break
        return out

    def _task_group(self, name: str) -> int:
        """Quantile-bucket task types by mean observed cpu·runtime demand."""
        if name not in self._task_stats or len(self._task_stats) <= 1:
            return self.n_groups - 1          # unknown → assume demanding
        means = {k: sum(v) / len(v) for k, v in self._task_stats.items() if v}
        if name not in means:
            return self.n_groups - 1
        ordered = sorted(means.values())
        mine = means[name]
        idx = sum(1 for m in ordered if m < mine)
        return min(int(idx * self.n_groups / max(len(ordered), 1)), self.n_groups - 1)

    def on_task_finished(self, task: Task, ctx: SchedulingContext) -> None:
        self._task_stats.setdefault(task.name, []).append(
            task.runtime_s * max(task.spec.resources.cpus, 1.0)
        )

    # -- strategy --
    def prioritize(self, tasks: List[Task], ctx: SchedulingContext) -> List[Task]:
        return self._prioritize_by_key(tasks, ctx)     # rank-min ordering

    def priority_token(self, ctx, dag):
        return None if dag is None else (dag.version,)

    def priority_key(self, task: Task, ctx: SchedulingContext) -> tuple:
        rank = ctx.dag_of(task).ranks()[task.task_id]
        return (-rank, task.spec.input_size, task.ready_time, task.task_id)

    def place(self, task: Task, nodes: List[NodeView],
              ctx: SchedulingContext) -> Optional[str]:
        fit = _fitting(task, nodes)
        if not fit:
            return None
        groups = self._node_groups(nodes)
        want = self._task_group(task.name)
        n_node_groups = max(groups.values()) + 1 if groups else 1
        want = min(want, n_node_groups - 1)
        best = [n for n in fit if groups.get(n.name, 0) == want]
        pool = best or fit
        # within the matched group, spread by free cpu
        return max(pool, key=lambda n: n.cpus_free).name


# ---------------------------------------------------------------------------
# Fair share across workflows (Yarn-like; used as a multi-tenancy ablation)
# ---------------------------------------------------------------------------
class FairStrategy(Strategy):
    name = "fair"

    def __init__(self) -> None:
        self._rr = _RoundRobinPlacer()
        self._place_key = PlacementKey(ring=self._rr)

    def prioritize(self, tasks: List[Task], ctx: SchedulingContext) -> List[Task]:
        running: Dict[str, int] = {}
        for wid, dag in ctx.dags.items():
            running[wid] = sum(1 for t in dag.tasks.values() if t.state.active)
        return sorted(
            tasks,
            key=lambda t: (running.get(t.spec.workflow_id, 0), t.submit_time, t.task_id),
        )

    def place_key(self, task, ctx):
        return self._place_key

    def place(self, task, nodes, ctx):
        return self._rr.pick(task, nodes)


# ---------------------------------------------------------------------------
# Bin-packing & data-locality placements — the remaining classic RM
# placement policies, expressed natively as indexed place keys.
# ---------------------------------------------------------------------------
class BestFitStrategy(Strategy):
    """FIFO order; tightest fitting node (classic best-fit packing:
    consolidate load so big slots stay whole for big tasks)."""

    name = "bestfit"

    _PLACE_KEY = PlacementKey(order="pack", key_fn=_pack_place_key)

    def prioritize(self, tasks: List[Task], ctx: SchedulingContext) -> List[Task]:
        return self._prioritize_by_key(tasks, ctx)

    def priority_token(self, ctx, dag):
        return ()

    def priority_key(self, task: Task, ctx: SchedulingContext) -> tuple:
        return (task.ready_time, task.submit_time, task.task_id)

    def place_key(self, task, ctx):
        return self._PLACE_KEY

    def place(self, task: Task, nodes: List[NodeView],
              ctx: SchedulingContext) -> Optional[str]:
        fit = _fitting(task, nodes)
        if not fit:
            return None
        return min(fit, key=_pack_place_key).name


class WorstFitStrategy(Strategy):
    """FIFO order; roomiest fitting node (worst-fit spread by raw free
    capacity — OriginalStrategy without the per-node normalisation)."""

    name = "worstfit"

    _PLACE_KEY = PlacementKey(order="unpack", key_fn=_unpack_place_key)

    def prioritize(self, tasks: List[Task], ctx: SchedulingContext) -> List[Task]:
        return self._prioritize_by_key(tasks, ctx)

    def priority_token(self, ctx, dag):
        return ()

    def priority_key(self, task: Task, ctx: SchedulingContext) -> tuple:
        return (task.ready_time, task.submit_time, task.task_id)

    def place_key(self, task, ctx):
        return self._PLACE_KEY

    def place(self, task: Task, nodes: List[NodeView],
              ctx: SchedulingContext) -> Optional[str]:
        fit = _fitting(task, nodes)
        if not fit:
            return None
        return min(fit, key=_unpack_place_key).name


class DataLocalityStrategy(Strategy):
    """Rank-min order; place on the node already holding the most input
    bytes (skipping staging), spread-fallback when no input-holding node
    fits. The candidate set is O(#inputs), so the indexed path probes a
    handful of named nodes instead of scanning the cluster."""

    name = "data_local"

    def prioritize(self, tasks: List[Task], ctx: SchedulingContext) -> List[Task]:
        return self._prioritize_by_key(tasks, ctx)

    def priority_token(self, ctx, dag):
        return None if dag is None else (dag.version,)

    def priority_key(self, task: Task, ctx: SchedulingContext) -> tuple:
        rank = ctx.dag_of(task).ranks()[task.task_id]
        return (-rank, task.spec.input_size, task.ready_time, task.task_id)

    @staticmethod
    def _resident_bytes(task: Task) -> Dict[str, float]:
        resident: Dict[str, float] = {}
        for r in task.spec.inputs:
            if r.location is not None and r.size_bytes > 0:
                resident[r.location] = resident.get(r.location, 0) + r.size_bytes
        return resident

    def place_key(self, task, ctx):
        resident = self._resident_bytes(task)
        return PlacementKey(prefer=resident or None,
                            order="spread", key_fn=_spread_place_key)

    def place(self, task: Task, nodes: List[NodeView],
              ctx: SchedulingContext) -> Optional[str]:
        fit = _fitting(task, nodes)
        if not fit:
            return None
        resident = self._resident_bytes(task)
        if resident:
            local = [n for n in fit if n.name in resident]
            if local:
                return max(local, key=lambda n: resident[n.name]).name
        return min(fit, key=_spread_place_key).name   # shared spread key


class GangSpreadStrategy(Strategy):
    """FIFO order; spread placement — with a gang member key.

    For ``nodes == 1`` tasks this is OriginalStrategy (same priority key,
    same indexed spread placement), so a gang-free workload runs
    bit-identical under either name. For ``nodes > 1`` tasks the engine
    consults ``gang_key_fn`` to pick *which* k fitting nodes host the
    gang: the spread key ranks all fitting nodes and the k least-loaded
    win, keeping gang members off the hottest nodes so a single busy
    node does not straggle the whole gang."""

    name = "gang_spread"

    _PLACE_KEY = PlacementKey(order="spread", key_fn=_spread_place_key)

    # member-selection key for k-node gangs: pure function of a node's
    # capacity fields (same contract as PlacementKey.key_fn — the engine
    # scores every fitting node and takes the k smallest)
    gang_key_fn = staticmethod(_spread_place_key)

    def prioritize(self, tasks: List[Task], ctx: SchedulingContext) -> List[Task]:
        return self._prioritize_by_key(tasks, ctx)

    def priority_token(self, ctx, dag):
        return ()

    def priority_key(self, task: Task, ctx: SchedulingContext) -> tuple:
        return (task.ready_time, task.submit_time, task.task_id)

    def place_key(self, task, ctx):
        return self._PLACE_KEY

    def place(self, task: Task, nodes: List[NodeView],
              ctx: SchedulingContext) -> Optional[str]:
        fit = _fitting(task, nodes)
        if not fit:
            return None
        return min(fit, key=_spread_place_key).name


STRATEGIES = {
    "original": OriginalStrategy,
    "fifo_rr": FIFORoundRobin,
    "rank_min_rr": lambda: RankStrategy("min"),
    "rank_max_rr": lambda: RankStrategy("max"),
    "heft": HEFTStrategy,
    "tarema": TaremaStrategy,
    "fair": FairStrategy,
    "bestfit": BestFitStrategy,
    "worstfit": WorstFitStrategy,
    "data_local": DataLocalityStrategy,
    "gang_spread": GangSpreadStrategy,
}


def make_strategy(name: str) -> Strategy:
    try:
        return STRATEGIES[name]()  # type: ignore[operator]
    except KeyError:
        raise ValueError(
            f"unknown strategy {name!r}; available: {sorted(STRATEGIES)}"
        ) from None
