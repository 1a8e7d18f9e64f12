"""Inter-workflow arbitration for the Common Workflow Scheduler.

The CWSI paper's central promise is a *workflow-aware* resource manager.
Awareness within one workflow is the job of the ``Strategy`` (ordering by
rank, placement by round robin / EFT / Tarema labels); this module owns the
question the companion proposal (arXiv:2302.07652) and WaaS platforms
(Hilman et al., arXiv:2006.01957) raise for multi-tenant clusters: *when
several workflows compete, whose ready task grabs resources next?*

An ``Arbiter`` interleaves per-workflow priority lists into the single
global order ``CommonWorkflowScheduler.schedule()`` walks:

  * ``FirstAppearanceArbiter`` — the pre-arbitration behaviour, preserved
    bit-identically: one global prioritize when every workflow shares the
    scheduler-wide strategy, else per-strategy groups in first-appearance
    order. This is the default ("arbiter off").
  * ``WeightedFairShareArbiter`` — weighted max-min fairness on the
    *running-allocation deficit*: each workflow owns a share weight (CWSI
    ``PUT /workflow/{wid}/share``); tasks are emitted from the workflow
    whose dominant-resource usage divided by its share is smallest,
    charging each emission so one backlogged tenant cannot flood a round.
  * ``StrictPriorityArbiter`` — shares act as priorities; all ready tasks
    of a higher-share workflow precede any task of a lower-share one.

Fairness bookkeeping is scalar: a task or allocation is charged its
**dominant share** — the max of its cpu/mem/chip request as a fraction of
cluster totals (the DRF measure). ``deficits()`` reports, per unfinished
workflow, ``share-weighted target − actual usage``; the targets are
normalised to current total usage, so deficits always sum to ~0 (share
conservation — asserted by the property suite and ``make bench``).

Preemptive arbitration (the CWSI "future plans" reaction to runtime
share changes) adds a second verb: ``preempt(running, actx)`` selects
victim *launches* to kill-and-requeue when the share assignment moved
under running work. The default is a no-op; ``WeightedFairShareArbiter``
picks victims on over-share workflows, smallest lost work first, never
pushing a victim below its own fair target, and only when an under-share
workflow has ready tasks waiting to absorb the freed capacity. The
engine bounds a round's victims by ``max_preemptions_per_round``
(0 = preemption off, bit-identical to the non-preemptive engine) and
charges each victim's lost allocation to its *preemption debt*, which
``order``/``preempt`` count as if it were still running — so a victim
cannot immediately reclaim the slot it was just evicted from (fair_share
converges instead of oscillating). Per-tenant queue quotas ride the same
context: a workflow at its ``max_running`` cap is skipped by the
deficit-heap pop (an O(log W) check, not a rescan), so its backlog never
claims emission slots it cannot use.
"""
from __future__ import annotations

import heapq
from abc import ABC, abstractmethod
from dataclasses import dataclass, field
from typing import (
    Any,
    Callable,
    Dict,
    List,
    Mapping,
    Optional,
    Tuple,
    TYPE_CHECKING,
)

from .dag import Task

if TYPE_CHECKING:  # pragma: no cover
    from .strategies import SchedulingContext, Strategy


def dominant_cost(cpus: float, mem: int, chips: int,
                  totals: Mapping[str, float]) -> float:
    """DRF scalar: the largest fraction of any one cluster resource used."""
    frac = 0.0
    if totals.get("cpus", 0) > 0 and chips == 0:
        frac = max(frac, cpus / totals["cpus"])
    if totals.get("mem", 0) > 0:
        frac = max(frac, mem / totals["mem"])
    if totals.get("chips", 0) > 0 and chips > 0:
        frac = max(frac, chips / totals["chips"])
    return frac


def deficits(shares: Mapping[str, float], usage: Mapping[str, float],
             active: List[str]) -> Dict[str, float]:
    """Per-workflow fair-share deficit: target − actual running usage.

    Targets split the *current* total usage by share weight over the
    ``active`` (unfinished) workflows, so the deficits sum to zero by
    construction; a positive deficit means the workflow is running below
    its entitlement.
    """
    if not active:
        return {}
    weight = {wid: max(float(shares.get(wid, 1.0)), 0.0) for wid in active}
    wsum = sum(weight.values())
    total = sum(usage.get(wid, 0.0) for wid in active)
    if wsum <= 0.0:
        return {wid: 0.0 for wid in active}
    return {
        wid: total * weight[wid] / wsum - usage.get(wid, 0.0)
        for wid in active
    }


@dataclass(frozen=True)
class WorkflowQuota:
    """Per-tenant queue quota (CWSI ``PUT /workflow/{wid}/quota``).

    ``max_running`` caps concurrently allocated launches (speculative
    copies included — they hold real resources); enforced at emission
    time so a capped workflow's backlog never claims order slots it
    cannot use. ``max_queued`` caps queued (non-terminal, not-running)
    tasks; enforced at submission (CWSI answers 429). ``None`` means
    unlimited."""

    max_running: Optional[int] = None
    max_queued: Optional[int] = None


@dataclass(frozen=True)
class PreemptionCandidate:
    """One running launch, as offered to ``Arbiter.preempt``.

    ``cost`` is the allocation's dominant share (the same scalar the
    usage accounting charges); ``progress`` is the work lost if this
    launch is killed (seconds since start; 0.0 for launches that are
    scheduled but not yet running — the cheapest victims)."""

    task: Task
    workflow_id: str
    cost: float
    progress: float


@dataclass
class ArbiterContext:
    """Everything an arbiter may consult, assembled per scheduling round.

    ``usage`` and ``totals`` are computed lazily (callables supplied by the
    engine) so the default first-appearance path pays nothing for them.
    """

    ctx: "SchedulingContext"
    strategy_for: Callable[[Task], "Strategy"]
    # set iff every workflow uses the scheduler-wide strategy (no overrides)
    single_strategy: Optional["Strategy"]
    shares: Mapping[str, float]
    appearance_fn: Callable[[], Dict[str, int]] = dict  # wid -> reg. order
    # usage_fn receives the (cached) cluster totals so one node scan per
    # round serves both the usage and totals views
    usage_fn: Callable[[Mapping[str, float]], Dict[str, float]] = (
        lambda totals: {})
    totals_fn: Callable[[], Dict[str, float]] = dict
    # engine-provided cached priority queues: (wid, tasks) -> sorted
    # [(key, task), ...] or None when the workflow's effective strategy
    # declares no cacheable key. ``None`` (the default, e.g. in unit
    # rigs) makes every arbiter fall back to fresh prioritize() calls.
    keyed_queue_fn: Optional[
        Callable[[str, List[Task]], Optional[List[Tuple[Any, Task]]]]
    ] = None
    # --- preemptive arbitration + quotas (defaults keep unit rigs and
    # non-preemptive engines on the exact pre-preemption code path) ---
    # per-workflow queue quotas (wid -> WorkflowQuota); empty = none set
    quotas: Mapping[str, WorkflowQuota] = field(default_factory=dict)
    # live allocation count for one workflow (quota checks are O(1) pulls
    # through this, not a rescan of the allocation map)
    running_count_fn: Callable[[str], int] = lambda wid: 0
    # *unplaceable* READY backlog per workflow (tasks no free node can
    # currently fit) — preemption only fires when an under-share
    # workflow has waiting work that needs capacity freed for it; work
    # that already fits will launch without anyone dying for it
    ready_counts: Mapping[str, int] = field(default_factory=dict)
    # dominant-share cost of killed-but-not-yet-relaunched work, per
    # victim workflow: counted as if still running so a fresh victim
    # cannot immediately reclaim its slot (anti-oscillation)
    preempt_debt: Mapping[str, float] = field(default_factory=dict)
    # engine bound on victims per preemption round; 0 = preemption off
    max_preemptions: int = 0
    _appearance: Optional[Dict[str, int]] = field(default=None, repr=False)
    _usage: Optional[Dict[str, float]] = field(default=None, repr=False)
    _totals: Optional[Dict[str, float]] = field(default=None, repr=False)

    @property
    def appearance(self) -> Dict[str, int]:
        if self._appearance is None:
            self._appearance = self.appearance_fn()
        return self._appearance

    @property
    def usage(self) -> Dict[str, float]:
        if self._usage is None:
            self._usage = self.usage_fn(self.totals)
        return self._usage

    @property
    def totals(self) -> Dict[str, float]:
        if self._totals is None:
            self._totals = self.totals_fn()
        return self._totals

    def share_of(self, wid: str) -> float:
        return float(self.shares.get(wid, 1.0))

    def keyed_queue(
        self, wid: str, tasks: List[Task]
    ) -> Optional[List[Tuple[Any, Task]]]:
        if self.keyed_queue_fn is None:
            return None
        return self.keyed_queue_fn(wid, tasks)

    def charged_usage(self, wid: str) -> float:
        """Running usage plus preemption debt — the fairness view.

        Guarded add: with no debt the float is the *identical object* the
        usage map holds, so the non-preemptive ordering stays bit-exact.
        """
        usage = self.usage.get(wid, 0.0)
        debt = self.preempt_debt.get(wid)
        return usage if not debt else usage + debt

    def running_allowance(self, wid: str) -> Optional[int]:
        """Remaining ``max_running`` emission budget (None = unlimited)."""
        quota = self.quotas.get(wid)
        if quota is None or quota.max_running is None:
            return None
        return max(quota.max_running - self.running_count_fn(wid), 0)


class Arbiter(ABC):
    """Interleaves per-workflow priority lists into one global order."""

    name: str = "abstract"

    @abstractmethod
    def order(self, ready: List[Task], actx: ArbiterContext) -> List[Task]:
        ...

    # ------------------------------------------------------------------
    def preempt(self, running: List[PreemptionCandidate],
                actx: ArbiterContext) -> List[PreemptionCandidate]:
        """Select victim launches to kill-and-requeue.

        Consulted by the engine only when a preemption trigger fired
        (share/arbiter change, new tenant) *and*
        ``max_preemptions_per_round > 0`` — the default engine never
        calls it. Policies without a preemption notion keep this no-op:
        an ordering-only arbiter is still a valid arbiter."""
        return []

    # ------------------------------------------------------------------
    def _workflow_queues(
        self, ready: List[Task], actx: ArbiterContext
    ) -> List[Tuple[str, List[Task]]]:
        """Per-workflow priority lists, first-appearance order of workflows.

        Each workflow's ready tasks are ordered by its *effective* strategy
        (per-workflow override or scheduler-wide). Restricting a strategy's
        per-task sort key to one workflow's tasks yields the subsequence of
        the global order, so intra-workflow priorities are unchanged by
        arbitration — only the interleaving between workflows is.

        When the engine supplies cached keyed queues, each workflow's
        list is served from its cache (re-sorted only when membership or
        the strategy's token changed) instead of a fresh per-round sort.
        """
        queues: Dict[str, List[Task]] = {}
        for task in ready:
            queues.setdefault(task.spec.workflow_id, []).append(task)
        out: List[Tuple[str, List[Task]]] = []
        for wid, tasks in queues.items():
            keyed = actx.keyed_queue(wid, tasks)
            if keyed is not None:
                out.append((wid, [t for _, t in keyed]))
            else:
                out.append(
                    (wid, actx.strategy_for(tasks[0]).prioritize(tasks,
                                                                 actx.ctx)))
        return out


class FirstAppearanceArbiter(Arbiter):
    """Arbiter "off": the exact pre-arbitration ordering.

    Without per-workflow strategy overrides, ready tasks of *all* workflows
    are prioritized by the single scheduler-wide strategy (cross-workflow
    order falls out of the strategy's own keys — first-appearance on ties).
    With overrides, tasks group by effective strategy in first-appearance
    order and each group is prioritized by its own strategy. Bit-identical
    to the first incremental engine; the golden-trace suite holds it there.
    """

    name = "first_appearance"

    def order(self, ready: List[Task], actx: ArbiterContext) -> List[Task]:
        if actx.single_strategy is not None:
            merged = self._merged_order(ready, actx)
            if merged is not None:
                return merged
            return actx.single_strategy.prioritize(ready, actx.ctx)
        ordered: List[Task] = []
        groups: List[Tuple["Strategy", List[Task]]] = []
        index: Dict[int, int] = {}
        for task in ready:
            strat = actx.strategy_for(task)
            i = index.get(id(strat))
            if i is None:
                index[id(strat)] = len(groups)
                groups.append((strat, [task]))
            else:
                groups[i][1].append(task)
        for strat, group in groups:
            merged = self._merged_order(group, actx)
            ordered.extend(merged if merged is not None
                           else strat.prioritize(group, actx.ctx))
        return ordered

    @staticmethod
    def _merged_order(tasks: List[Task],
                      actx: ArbiterContext) -> Optional[List[Task]]:
        """Cross-workflow order via a k-way merge of cached keyed queues.

        A global ``sorted(tasks, key)`` equals the merge of per-workflow
        lists sorted by the same total key (the engine suffixes each key
        with a promotion sequence number, making ties impossible — which
        also reproduces the stable sort's promotion-order tie-breaking).
        Returns None when any queue is uncacheable, falling back to the
        plain prioritize() path.
        """
        if actx.keyed_queue_fn is None:
            return None
        buckets: Dict[str, List[Task]] = {}
        for task in tasks:
            buckets.setdefault(task.spec.workflow_id, []).append(task)
        keyed_lists = []
        for wid, bucket in buckets.items():
            keyed = actx.keyed_queue(wid, bucket)
            if keyed is None:
                return None
            keyed_lists.append(keyed)
        if len(keyed_lists) == 1:
            return [t for _, t in keyed_lists[0]]
        return [t for _, t in heapq.merge(*keyed_lists,
                                          key=lambda kv: kv[0])]


class WeightedFairShareArbiter(Arbiter):
    """Weighted max-min: emit from the workflow with the lowest
    usage-to-share ratio, charging each emitted task's dominant cost.

    ``usage`` starts from the *running allocations* (what the cluster is
    actually executing), so a workflow that has been starved of launches
    carries the largest deficit and wins the next slots; charging virtual
    usage as tasks are emitted interleaves within the round instead of
    letting one tenant drain first. Zero-share workflows sort strictly
    after every positive-share workflow in the emitted order; note the
    arbiter only *orders* — the engine still launches anything later in
    the order that fits when earlier tasks are unplaceable, so best-effort
    tenants can fill capacity positive-share tenants cannot use.
    """

    name = "fair_share"

    def order(self, ready: List[Task], actx: ArbiterContext) -> List[Task]:
        queues = self._workflow_queues(ready, actx)
        if len(queues) <= 1:
            if not queues:
                return []
            wid, q = queues[0]
            allow = actx.running_allowance(wid)
            return q if allow is None else q[:allow]
        totals = actx.totals
        virt: Dict[str, float] = {}
        share: Dict[str, float] = {}
        for wid, _ in queues:
            virt[wid] = actx.charged_usage(wid)
            share[wid] = max(actx.share_of(wid), 0.0)

        def key(wid: str) -> Tuple[float, float]:
            # zero-share workflows are a strictly lower tier: serviced only
            # when no positive-share workflow has ready tasks, no matter
            # how lopsided the positive-share ratios get
            if share[wid] <= 0.0:
                return (1.0, virt[wid])
            return (0.0, virt[wid] / share[wid])

        # deficit heap: each live workflow has exactly one entry keyed by
        # (tier, usage/share ratio, appearance, wid). Only the emitting
        # workflow's ratio changes per emission (its virtual charge), so
        # it alone is re-pushed — an emission costs O(log W) instead of
        # the former O(W) min() scan over every live queue. max_running
        # quotas are enforced right here: a capped workflow simply is not
        # (re-)pushed once its emission allowance is spent, so the check
        # is O(log W) alongside the pop, never a queue rescan.
        heap: List[Tuple[float, float, int, str, List[Task]]] = []
        allowance: Dict[str, Optional[int]] = {}
        for wid, q in queues:
            allowance[wid] = actx.running_allowance(wid)
            if q and allowance[wid] != 0:
                tier, ratio = key(wid)
                heap.append((tier, ratio,
                             actx.appearance.get(wid, 1 << 30), wid, q))
        heapq.heapify(heap)
        heads = {wid: 0 for wid, _ in queues}
        out: List[Task] = []
        while heap:
            _, _, app, wid, q = heapq.heappop(heap)
            task = q[heads[wid]]
            heads[wid] += 1
            out.append(task)
            res = task.spec.resources
            # charge at least a token amount so zero-cost tasks still
            # rotate; a gang is one emission holding k nodes' resources
            # (gated so nodes == 1 keeps the exact pre-gang float path)
            if res.nodes > 1:
                cost = dominant_cost(res.cpus * res.nodes,
                                     res.mem_bytes * res.nodes,
                                     res.chips * res.nodes, totals)
            else:
                cost = dominant_cost(res.cpus, res.mem_bytes, res.chips,
                                     totals)
            virt[wid] += max(cost, 1e-9)
            allow = allowance[wid]
            if allow is not None:
                allow -= 1
                allowance[wid] = allow
            if heads[wid] < len(q) and (allow is None or allow > 0):
                tier, ratio = key(wid)
                heapq.heappush(heap, (tier, ratio, app, wid, q))
        return out

    def preempt(self, running: List[PreemptionCandidate],
                actx: ArbiterContext) -> List[PreemptionCandidate]:
        """Victims on over-share workflows, smallest lost work first.

        Per-workflow fair targets split the *current total running usage*
        by share weight (the same normalisation as ``deficits()``), held
        fixed over the round: the capacity being reallocated is what is
        running now. A launch is eligible only while its workflow is
        still *above* its own target — preemption trims a tenant toward
        its entitlement, overshooting below it by at most one launch's
        cost (launches are indivisible; without that allowance a tenant
        holding the cluster in one big launch could never be preempted at
        all) — and the round takes no more victims than there are
        *unplaceable* ready tasks waiting on under-share workflows (a
        kill with no starved beneficiary is pure churn — the engine
        already filters ``ready_counts`` down to work no free node can
        fit). Victims are taken cheapest-first:
        scheduled-not-started launches (zero lost work), then
        shortest-running, ties by workflow appearance then task id, so
        the selection is deterministic.
        """
        budget = actx.max_preemptions
        if budget <= 0 or not running:
            return []
        wids = {c.workflow_id for c in running}
        wids.update(actx.ready_counts)
        # two usage views, deliberately asymmetric: victim eligibility
        # runs on REAL running usage (only capacity that is actually
        # running can be reclaimed — outstanding debt must not make an
        # already-preempted tenant look over-share again, or repeated
        # triggers would strip it below its real entitlement), while the
        # beneficiary check runs on CHARGED usage (debt counts: a fresh
        # victim's requeued backlog must not read as starvation and set
        # off counter-preemption of the tenants it just yielded to).
        real = {wid: actx.usage.get(wid, 0.0) for wid in wids}
        charged = {wid: actx.charged_usage(wid) for wid in wids}
        share = {wid: max(actx.share_of(wid), 0.0) for wid in wids}
        wsum = sum(share.values())
        total = sum(real.values())
        if wsum <= 0.0 or total <= 0.0:
            return []
        target = {wid: total * share[wid] / wsum for wid in wids}
        # beneficiaries: under-target workflows with ready work waiting
        waiting = sum(
            n for wid, n in actx.ready_counts.items()
            if n > 0 and share.get(wid, 0.0) > 0.0
            and charged.get(wid, 0.0) < target.get(wid, 0.0) - 1e-12)
        budget = min(budget, waiting)
        if budget <= 0:
            return []
        pool = sorted(
            (c for c in running if real[c.workflow_id]
             > target[c.workflow_id] + 1e-12),
            key=lambda c: (c.progress,
                           actx.appearance.get(c.workflow_id, 1 << 30),
                           c.task.task_id))
        victims: List[PreemptionCandidate] = []
        left = dict(real)
        for cand in pool:
            if len(victims) >= budget:
                break
            wid = cand.workflow_id
            if left[wid] > target[wid] + 1e-12:
                victims.append(cand)
                left[wid] -= cand.cost
        return victims


class StrictPriorityArbiter(Arbiter):
    """Shares act as strict priorities: every ready task of a higher-share
    workflow precedes any task of a lower-share one; ties fall back to
    first-appearance order. Starvation of low-priority tenants is the
    *intended* semantics here (e.g. production vs. best-effort reruns)."""

    name = "strict_priority"

    def order(self, ready: List[Task], actx: ArbiterContext) -> List[Task]:
        queues = self._workflow_queues(ready, actx)
        queues.sort(key=lambda wq: (-actx.share_of(wq[0]),
                                    actx.appearance.get(wq[0], 1 << 30),
                                    wq[0]))
        out: List[Task] = []
        for _, q in queues:
            out.extend(q)
        return out


ARBITERS: Dict[str, Callable[[], Arbiter]] = {
    "first_appearance": FirstAppearanceArbiter,
    "fair_share": WeightedFairShareArbiter,
    "strict_priority": StrictPriorityArbiter,
}


def make_arbiter(name: str) -> Arbiter:
    try:
        return ARBITERS[name]()
    except KeyError:
        raise ValueError(
            f"unknown arbiter {name!r}; available: {sorted(ARBITERS)}"
        ) from None
