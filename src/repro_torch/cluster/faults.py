"""Declarative, seeded fault injection for the cluster substrate.

A ``FaultPlan`` is a frozen description of everything that will go wrong
in a run: correlated failure-domain outages (every node sharing a label
dies at one instant, and optionally rejoins), single-node flap
(down-then-up), per-launch report faults (transient failures, permanent
"doomed" tasks, silently lost start/finish reports), and — via
``FaultyTransport`` — lossy/duplicating CWSI message delivery. Plans are
data: the same plan against the same cluster and seed replays the exact
same fault sequence, so chaos runs are as reproducible as clean ones.

The injection points are the seams the system already has:

* node-level faults become ordinary ``NODE_FAIL``/``NODE_JOIN`` events
  in the simulator's queue (``FaultInjector.arm``);
* per-launch faults are consulted by ``ClusterSimulator.launch`` through
  ``sim.fault_injector`` (a lost report means the event is simply never
  pushed — exactly what a dead executor looks like to the scheduler,
  and what the engine's report leases exist to reclaim);
* transport faults wrap any ``str -> str`` CWSI transport, raising
  ``TransportError`` for losses (the retrying client's cue) and
  re-delivering for duplicates (the dedup window's problem).

The injector draws from its own ``numpy`` generator, never the
simulator's, and every probabilistic draw is guarded by ``prob > 0`` —
a zero plan consumes no randomness, so a run with an all-zero FaultPlan
attached is bit-identical to a run with no injector at all.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Tuple

import numpy as np

from ..core.cwsi_client import TransportError
from ..core.scheduler import NodeInfo


@dataclass(frozen=True)
class DomainOutage:
    """All nodes labelled ``{key: domain}`` fail at ``time``; with a
    ``duration`` they rejoin together at ``time + duration``."""

    time: float
    domain: str
    duration: Optional[float] = None
    key: str = "rack"


@dataclass(frozen=True)
class NodeFlap:
    """One node drops at ``time`` and rejoins ``down_for`` later."""

    time: float
    node: str
    down_for: float


@dataclass(frozen=True)
class FaultPlan:
    """The full seeded fault schedule for one run (see module docstring).

    ``doomed_tasks`` fail on *every* launch (permanent failures: the
    retry budget drains and the task goes terminal-ERROR);
    ``transient_failure_prob`` fails any given launch once in a while
    (a retry normally succeeds). ``drop_start_prob`` loses both of a
    launch's reports (silent executor death at launch),
    ``drop_finish_prob`` loses only the finish (death mid-run) — both
    are invisible to the scheduler until a report lease expires."""

    seed: int = 0
    outages: Tuple[DomainOutage, ...] = ()
    flaps: Tuple[NodeFlap, ...] = ()
    transient_failure_prob: float = 0.0
    doomed_tasks: Tuple[str, ...] = ()
    drop_start_prob: float = 0.0
    drop_finish_prob: float = 0.0

    def injector(self) -> "FaultInjector":
        return FaultInjector(self)


@dataclass(frozen=True)
class LaunchVerdict:
    """What the injector decided for one launch."""

    fail: bool = False
    reason: Optional[str] = None
    fail_frac: float = 0.5        # fraction of the runtime before death
    drop_start: bool = False      # lose start AND finish reports
    drop_finish: bool = False     # lose only the finish report


_CLEAN = LaunchVerdict()


class FaultInjector:
    """Executes a ``FaultPlan`` against one simulator run."""

    def __init__(self, plan: FaultPlan) -> None:
        self.plan = plan
        self.rng = np.random.default_rng(plan.seed)
        self._doomed = frozenset(plan.doomed_tasks)
        self.injected_failures = 0
        self.dropped_starts = 0
        self.dropped_finishes = 0
        self.outage_nodes = 0

    def arm(self, sim: Any, nodes: List[NodeInfo]) -> None:
        """Schedule the plan's node faults into ``sim``'s event queue and
        hook per-launch faults (sets ``sim.fault_injector``).

        Call after constructing the simulator with ``nodes`` and before
        ``run()``; unknown domains/nodes raise immediately — a plan that
        silently injects nothing is worse than one that fails loudly."""
        by_name = {n.name: n for n in nodes}
        for o in self.plan.outages:
            members = [n for n in nodes
                       if n.labels.get(o.key) == o.domain]
            if not members:
                raise ValueError(
                    f"no nodes carry {o.key}={o.domain!r}: outage would "
                    f"inject nothing")
            for n in members:
                sim.fail_node_at(o.time, n.name)
                self.outage_nodes += 1
                if o.duration is not None:
                    sim.join_node_at(o.time + o.duration, n)
        for f in self.plan.flaps:
            info = by_name.get(f.node)
            if info is None:
                raise ValueError(f"unknown flap node {f.node!r}")
            sim.fail_node_at(f.time, f.node)
            sim.join_node_at(f.time + f.down_for, info)
        sim.fault_injector = self

    def launch_faults(self, task: Any) -> LaunchVerdict:
        """Draw this launch's fate. At most one fault per launch, checked
        in severity order; every draw is guarded so zero-prob plans pull
        nothing from the generator."""
        p = self.plan
        if task.task_id in self._doomed:
            self.injected_failures += 1
            return LaunchVerdict(fail=True, reason="injected: permanent")
        if p.transient_failure_prob > 0 \
                and self.rng.random() < p.transient_failure_prob:
            self.injected_failures += 1
            return LaunchVerdict(fail=True, reason="injected: transient")
        if p.drop_start_prob > 0 \
                and self.rng.random() < p.drop_start_prob:
            self.dropped_starts += 1
            return LaunchVerdict(drop_start=True)
        if p.drop_finish_prob > 0 \
                and self.rng.random() < p.drop_finish_prob:
            self.dropped_finishes += 1
            return LaunchVerdict(drop_finish=True)
        return _CLEAN


class FaultyTransport:
    """Wrap a ``str -> str`` CWSI transport with seeded message faults.

    * ``drop_request_prob`` — the request never arrives: ``TransportError``
      without touching the inner transport.
    * ``drop_response_prob`` — the server acted but the answer is lost:
      inner transport called, then ``TransportError``. The ambiguous
      case exactly-once dedup exists for.
    * ``duplicate_prob`` — the request is delivered twice; the extra
      delivery's response is discarded. With ``delay_prob`` the second
      copy is held back and lands *after* later traffic (reordering).

    Raised ``TransportError``\\ s are what ``ReliableCWSIClient`` retries
    on; a bare ``CWSIClient`` over a faulty transport simply fails."""

    def __init__(self, inner: Callable[[str], str],
                 drop_request_prob: float = 0.0,
                 drop_response_prob: float = 0.0,
                 duplicate_prob: float = 0.0,
                 delay_prob: float = 0.0,
                 seed: int = 0) -> None:
        self.inner = inner
        self.drop_request_prob = float(drop_request_prob)
        self.drop_response_prob = float(drop_response_prob)
        self.duplicate_prob = float(duplicate_prob)
        self.delay_prob = float(delay_prob)
        self.rng = np.random.default_rng(seed)
        self._delayed: List[str] = []
        self.dropped_requests = 0
        self.dropped_responses = 0
        self.duplicated_requests = 0
        self.delayed_deliveries = 0

    def __call__(self, raw: str) -> str:
        if self._delayed:
            # late duplicates from earlier calls land first, out of
            # order with respect to their original traffic
            for old in self._delayed:
                self.inner(old)
            self.delayed_deliveries += len(self._delayed)
            self._delayed.clear()
        if self.drop_request_prob > 0 \
                and self.rng.random() < self.drop_request_prob:
            self.dropped_requests += 1
            raise TransportError("request lost in transit")
        resp = self.inner(raw)
        if self.duplicate_prob > 0 \
                and self.rng.random() < self.duplicate_prob:
            self.duplicated_requests += 1
            if self.delay_prob > 0 \
                    and self.rng.random() < self.delay_prob:
                self._delayed.append(raw)
            else:
                self.inner(raw)
        if self.drop_response_prob > 0 \
                and self.rng.random() < self.drop_response_prob:
            self.dropped_responses += 1
            raise TransportError("response lost in transit")
        return resp

    def flush(self) -> None:
        """Deliver any still-held delayed duplicates."""
        for old in self._delayed:
            self.inner(old)
        self.delayed_deliveries += len(self._delayed)
        self._delayed.clear()
