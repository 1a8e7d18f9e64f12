"""Node-capacity index: O(log N) placement queries over the cluster.

Earlier work made the *event and ordering* path incremental, but every
scheduling round still paid O(N) per launch: snapshotting all N node
views, the ``any(fits)`` feasibility scan, the per-round
``max(mem_bytes)`` cap, and each strategy's full ``views`` walk. At
resource-manager scale (the CWSI paper positions the scheduler *inside*
the RM, so it answers placement at cluster scale, not workflow scale)
that linear factor dominates. This module replaces it with order
statistics maintained as launch/release/churn deltas:

  * a **fit tree** (segment tree of per-resource free maxima) over the
    up-nodes in their registration order — ``first_fit_slot`` /
    ``exists_fit`` answer "which node fits this demand first" and the
    feasibility watermark in O(log N) descent steps instead of an O(N)
    scan, reproducing the insertion-ordered linear walk bit for bit
    (the leftmost admitted leaf IS the first fitting node);
  * the same tree over the **name-sorted ring**, backing the paper's
    round-robin placement (``_RoundRobinPlacer`` walks this instead of
    rebuilding an O(N) name→view dict per pick);
  * **order lists**: per placement-key sorted (key, slot) lists for
    score-based strategies (spread / speed / best-fit / worst-fit),
    re-positioned by bisection when a launch or release moves one
    node's key — the first *fitting* entry equals
    ``max(fit, key=score)`` including Python's first-on-tie semantics,
    because every key is suffixed with the registration slot (the walk
    costs the first-fit position in key order — typically O(1), see
    ``ordered_first_fit`` for the pack-key worst case — never the
    oracle's unconditional O(N));
  * O(1) **aggregates**: the largest up-node memory (the per-round
    ``mem_cap``) from a sorted multiset maintained on node churn, and
    the cluster totals the arbiter's dominant-share accounting reads
    (recomputed per *churn event*, in registration order, so the floats
    are bit-identical to the old per-round rescan).

Membership changes (node join/leave) mark the index dirty and the next
query rebuilds in O(N log N); everything else is a point update. The
index holds *references* to the engine's node states — free capacities
are never duplicated, the engine just calls ``touch`` after mutating
them — so there is no state to drift out of sync.

Counters: ``node_fit_ops`` counts per-node fit evaluations (tree
leaves, order-list walks, candidate probes); ``index_updates`` counts
structure maintenance operations. The node-scale sweep in
``benchmarks/bench_sched_scale.py`` asserts these stay logarithmic
where the legacy walk was linear.
"""
from __future__ import annotations

from bisect import bisect_left, insort
from typing import Any, Callable, Dict, List, Optional, Tuple


def fits_demand(cpus_free: float, mem_free: int, chips_free: int,
                cpus: float, mem: int, chips: int) -> bool:
    """THE admission rule: does (cpus_free, mem_free, chips_free) fit a
    (cpus, mem, chips) demand? Single source of truth — NodeView's
    ``fits_demand``, the index's per-node probes, and the fit tree's
    subtree pruning all call this, so the indexed/oracle bit-identity
    invariant cannot drift when the rule changes."""
    if chips > 0:
        return chips_free >= chips and mem_free >= mem
    return cpus_free >= cpus and mem_free >= mem


def _fits(st: Any, cpus: float, mem: int, chips: int) -> bool:
    """``fits_demand`` over an engine node state."""
    return fits_demand(st.cpus_free, st.mem_free, st.chips_free,
                       cpus, mem, chips)


class NodeCaps:
    """Read-only capacity facade over one engine node state.

    This is what a strategy's ``place_key`` key function sees: the
    NodeView capacity fields, read live from the engine's bookkeeping
    (never a stale copy)."""

    __slots__ = ("_st",)

    def __init__(self, st: Any) -> None:
        self._st = st

    @property
    def name(self) -> str:
        return self._st.info.name

    @property
    def cpus_total(self) -> float:
        return self._st.info.cpus

    @property
    def mem_total(self) -> int:
        return self._st.info.mem_bytes

    @property
    def chips_total(self) -> int:
        return self._st.info.chips

    @property
    def cpus_free(self) -> float:
        return self._st.cpus_free

    @property
    def mem_free(self) -> int:
        return self._st.mem_free

    @property
    def chips_free(self) -> int:
        return self._st.chips_free

    @property
    def speed_factor(self) -> float:
        return self._st.info.speed_factor


class _FitTree:
    """Segment tree of (max cpus_free, max mem_free, max chips_free).

    ``first_fit`` finds the leftmost leaf in [lo, hi) whose node admits
    the demand. A subtree is pruned when its maxima cannot admit it; at
    a leaf the maxima ARE the node's frees, so the admission test is
    exact. The conjunctive demand (cpus AND mem) means a subtree whose
    maxima come from different nodes can admit without containing a fit
    — the descent then backtracks, so the worst case is linear, but on
    real capacity distributions the leftmost fit is found in O(log N).
    """

    __slots__ = ("size", "maxc", "maxm", "maxk")

    def __init__(self, caps: List[Tuple[float, int, int]]) -> None:
        size = 1
        while size < max(len(caps), 1):
            size <<= 1
        self.size = size
        self.maxc = [-1.0] * (2 * size)
        self.maxm = [-1] * (2 * size)
        self.maxk = [-1] * (2 * size)
        for i, (c, m, k) in enumerate(caps):
            self.maxc[size + i] = c
            self.maxm[size + i] = m
            self.maxk[size + i] = k
        for i in range(size - 1, 0, -1):
            self._pull(i)

    def _pull(self, i: int) -> None:
        l, r = 2 * i, 2 * i + 1
        self.maxc[i] = self.maxc[l] if self.maxc[l] >= self.maxc[r] else self.maxc[r]
        self.maxm[i] = self.maxm[l] if self.maxm[l] >= self.maxm[r] else self.maxm[r]
        self.maxk[i] = self.maxk[l] if self.maxk[l] >= self.maxk[r] else self.maxk[r]

    def update(self, i: int, cpus: float, mem: int, chips: int) -> None:
        i += self.size
        self.maxc[i], self.maxm[i], self.maxk[i] = cpus, mem, chips
        i >>= 1
        while i:
            self._pull(i)
            i >>= 1

    def _admits(self, i: int, cpus: float, mem: int, chips: int) -> bool:
        return fits_demand(self.maxc[i], self.maxm[i], self.maxk[i],
                           cpus, mem, chips)

    def first_fit(self, lo: int, hi: int, cpus: float, mem: int, chips: int,
                  skip: int = -1) -> Tuple[Optional[int], int]:
        """Leftmost fitting leaf in [lo, hi), skipping ``skip``.

        Returns (slot or None, number of leaf fit evaluations)."""
        if lo >= hi:
            return None, 0
        checks = 0
        stack = [(1, 0, self.size)]
        while stack:
            node, l, r = stack.pop()
            if r <= lo or hi <= l:
                continue
            if r - l == 1:
                checks += 1
                if l != skip and self._admits(node, cpus, mem, chips):
                    return l, checks
                continue
            if not self._admits(node, cpus, mem, chips):
                continue
            mid = (l + r) >> 1
            stack.append((2 * node + 1, mid, r))
            stack.append((2 * node, l, mid))
        return None, checks

    def collect_fits(self, lo: int, hi: int, cpus: float, mem: int,
                     chips: int, need: int) -> Tuple[List[int], int]:
        """Leftmost ``need`` fitting leaves in [lo, hi), left to right.

        The gang query: same pruned descent as ``first_fit``, but the
        walk continues until ``need`` admitting leaves are collected (or
        the range is exhausted — the caller treats a short list as "no
        gang fits", all-or-nothing). Returns (slots, leaf evaluations).
        """
        out: List[int] = []
        if lo >= hi or need <= 0:
            return out, 0
        checks = 0
        stack = [(1, 0, self.size)]
        while stack:
            node, l, r = stack.pop()
            if r <= lo or hi <= l:
                continue
            if r - l == 1:
                checks += 1
                if self._admits(node, cpus, mem, chips):
                    out.append(l)
                    if len(out) >= need:
                        return out, checks
                continue
            if not self._admits(node, cpus, mem, chips):
                continue
            mid = (l + r) >> 1
            stack.append((2 * node + 1, mid, r))
            stack.append((2 * node, l, mid))
        return out, checks


class _Entry:
    __slots__ = ("name", "st", "caps", "slot", "ring_pos", "keys")

    def __init__(self, name: str, st: Any) -> None:
        self.name = name
        self.st = st
        self.caps = NodeCaps(st)
        self.slot = -1
        self.ring_pos = -1
        self.keys: Dict[str, tuple] = {}


class _Order:
    """One sorted (place key, slot) list; slot suffix = registration
    order, reproducing the linear scan's first-on-tie pick."""

    __slots__ = ("order_id", "key_fn", "dynamic", "items", "idle_touches")

    def __init__(self, order_id: str, key_fn: Callable[[NodeCaps], tuple],
                 dynamic: bool) -> None:
        self.order_id = order_id
        self.key_fn = key_fn
        self.dynamic = dynamic
        self.items: List[Tuple[tuple, int]] = []
        # free-capacity updates since the last query; when this passes
        # _ORDER_IDLE_LIMIT the order is dropped (it rebuilds lazily on
        # the next query), so launches stop paying re-seating costs for
        # strategies no longer in use
        self.idle_touches = 0

    def rebuild(self, entries: List[_Entry]) -> None:
        items = []
        for e in entries:
            key = self.key_fn(e.caps)
            e.keys[self.order_id] = key
            items.append((key, e.slot))
        items.sort()
        self.items = items

    def reposition(self, entry: _Entry) -> bool:
        old = entry.keys.get(self.order_id)
        new = self.key_fn(entry.caps)
        if new == old:
            return False
        i = bisect_left(self.items, (old, entry.slot))
        del self.items[i]
        insort(self.items, (new, entry.slot))
        entry.keys[self.order_id] = new
        return True


# a dynamic order untouched-by-queries for this many free-capacity
# updates is considered abandoned and evicted (rebuilt on next use).
# The effective limit scales with cluster size (max(limit, 8N)): 8N
# repositions cost about one O(N log N) rebuild, so a live strategy
# that places rarely amortises cleanly instead of thrashing rebuilds,
# while truly abandoned orders still age out.
_ORDER_IDLE_LIMIT = 1024


class NodeCapacityIndex:
    """Order statistics over the up-nodes, maintained as deltas."""

    def __init__(self) -> None:
        self._by_name: Dict[str, _Entry] = {}
        self._entries: List[_Entry] = []
        self._ring_entries: List[_Entry] = []
        self._ring_names: Tuple[str, ...] = ()
        self._tree: Optional[_FitTree] = None
        self._ring_tree: Optional[_FitTree] = None
        self._orders: Dict[str, _Order] = {}
        self._mem_sorted: List[int] = []
        self._totals: Optional[Dict[str, float]] = None
        self._dirty = True
        # bumped on every membership change; round-robin placers compare
        # it against the version they last resynced their ring at
        self.membership_version = 0
        self.node_fit_ops = 0       # per-node fit evaluations
        self.index_updates = 0      # structure maintenance operations

    # -- membership (rare: node join/leave) ----------------------------
    def add(self, name: str, st: Any) -> None:
        self._by_name[name] = _Entry(name, st)
        self.membership_version += 1
        self._dirty = True

    def remove(self, name: str) -> None:
        if self._by_name.pop(name, None) is not None:
            self.membership_version += 1
            self._dirty = True

    def size(self) -> int:
        return len(self._by_name)

    def _ensure(self) -> None:
        if not self._dirty:
            return
        entries = list(self._by_name.values())
        for i, e in enumerate(entries):
            e.slot = i
        self._entries = entries
        caps = [(e.st.cpus_free, e.st.mem_free, e.st.chips_free)
                for e in entries]
        self._tree = _FitTree(caps)
        ring = sorted(entries, key=lambda e: e.name)
        for pos, e in enumerate(ring):
            e.ring_pos = pos
        self._ring_entries = ring
        self._ring_names = tuple(e.name for e in ring)
        self._ring_tree = _FitTree(
            [(e.st.cpus_free, e.st.mem_free, e.st.chips_free) for e in ring])
        self._mem_sorted = sorted(e.st.info.mem_bytes for e in entries)
        for order in self._orders.values():
            order.rebuild(entries)
        self._totals = None
        self._dirty = False
        self.index_updates += max(len(entries), 1)

    # -- point updates (hot: every launch/release) ---------------------
    def touch(self, name: str) -> None:
        """The node's free capacities changed: re-seat it everywhere."""
        if self._dirty:
            return              # next query rebuilds from live state
        e = self._by_name.get(name)
        if e is None:
            return
        st = e.st
        c, m, k = st.cpus_free, st.mem_free, st.chips_free
        self._tree.update(e.slot, c, m, k)
        self._ring_tree.update(e.ring_pos, c, m, k)
        self.index_updates += 1
        stale: List[str] = []
        idle_limit = max(_ORDER_IDLE_LIMIT, 8 * len(self._entries))
        for order in self._orders.values():
            if not order.dynamic:
                continue
            order.idle_touches += 1
            if order.idle_touches > idle_limit:
                # no query since _ORDER_IDLE_LIMIT capacity updates: the
                # declaring strategy is gone — stop paying for it. Must
                # be dropped (not just skipped): a skipped reposition
                # would leave a stale order that later queries trust.
                stale.append(order.order_id)
                continue
            if order.reposition(e):
                self.index_updates += 1
        for order_id in stale:
            del self._orders[order_id]

    def on_speed_change(self, name: str) -> None:
        """Speed moved (fit-irrelevant, but speed-keyed orders re-seat)."""
        if self._dirty:
            return
        e = self._by_name.get(name)
        if e is None:
            return
        for order in self._orders.values():
            if order.reposition(e):
                self.index_updates += 1

    # -- queries --------------------------------------------------------
    def exists_fit(self, cpus: float, mem: int, chips: int) -> bool:
        """The feasibility watermark: does ANY up-node fit this demand?"""
        return self.first_fit_slot(cpus, mem, chips) is not None

    def first_fit_slot(self, cpus: float, mem: int, chips: int,
                       skip_name: Optional[str] = None) -> Optional[str]:
        """First fitting node in registration order (the exact node the
        insertion-ordered linear scan would return)."""
        self._ensure()
        n = len(self._entries)
        if n == 0:
            return None
        skip = -1
        if skip_name is not None:
            se = self._by_name.get(skip_name)
            if se is not None:
                skip = se.slot
        slot, checks = self._tree.first_fit(0, n, cpus, mem, chips, skip)
        self.node_fit_ops += checks
        return self._entries[slot].name if slot is not None else None

    # -- gang queries (nodes=k all-or-nothing co-placement) -------------
    def exists_gang_fit(self, k: int, cpus: float, mem: int,
                        chips: int) -> bool:
        """Do at least ``k`` distinct up-nodes EACH fit the per-node
        demand? The gang feasibility watermark — one pruned tree walk
        with early exit at the k-th admitting leaf, not k probes."""
        if k <= 1:
            return self.exists_fit(cpus, mem, chips)
        self._ensure()
        n = len(self._entries)
        if n < k:
            return False
        slots, checks = self._tree.collect_fits(0, n, cpus, mem, chips, k)
        self.node_fit_ops += checks
        return len(slots) >= k

    def gang_slots(self, k: int, cpus: float, mem: int, chips: int,
                   key_fn: Optional[Callable[[NodeCaps], tuple]] = None,
                   ) -> List[str]:
        """The ``k`` member nodes for a gang launch, or ``[]`` if fewer
        than k distinct nodes fit (all-or-nothing — never a partial
        list).

        Default order is registration order (the first k nodes the
        insertion-ordered linear scan admits — the ``legacy_scan``
        oracle in the engine reproduces exactly this). With ``key_fn``
        the k admitted nodes are taken in (key, registration slot)
        order instead — the gang_spread strategy passes the spread key
        so a gang lands on the emptiest nodes first.
        """
        self._ensure()
        n = len(self._entries)
        if n < k or k <= 0:
            return []
        if key_fn is None:
            slots, checks = self._tree.collect_fits(0, n, cpus, mem,
                                                    chips, k)
            self.node_fit_ops += checks
            if len(slots) < k:
                return []
            return [self._entries[s].name for s in slots]
        # key order: score every fitting node, take the best k. A gang
        # pick perturbs k nodes at once, so the per-launch reposition
        # amortisation of _Order does not apply — scored directly.
        scored: List[Tuple[tuple, int]] = []
        for e in self._entries:
            self.node_fit_ops += 1
            if _fits(e.st, cpus, mem, chips):
                scored.append((key_fn(e.caps), e.slot))
        if len(scored) < k:
            return []
        scored.sort()
        return [self._entries[slot].name for _, slot in scored[:k]]

    def ring(self) -> Tuple[Tuple[str, ...], int]:
        """(name-sorted up-node names, membership version) for RR rings."""
        self._ensure()
        return self._ring_names, self.membership_version

    def ring_first_fit(self, start: int, cpus: float, mem: int,
                       chips: int) -> Optional[int]:
        """First fitting ring position walking cyclically from ``start``
        — the node ``_RoundRobinPlacer``'s lazy ring walk would pick."""
        self._ensure()
        n = len(self._ring_entries)
        if n == 0:
            return None
        pos, checks = self._ring_tree.first_fit(start, n, cpus, mem, chips)
        self.node_fit_ops += checks
        if pos is None and start > 0:
            pos, checks = self._ring_tree.first_fit(0, start, cpus, mem, chips)
            self.node_fit_ops += checks
        return pos

    def ordered_first_fit(self, order_id: str,
                          key_fn: Callable[[NodeCaps], tuple], dynamic: bool,
                          cpus: float, mem: int, chips: int) -> Optional[str]:
        """First fitting node in (place key, registration slot) order —
        ``max(fit, key=score)`` of the linear scan, ties included.

        ``order_id`` names the key's semantics: the structure is built
        once per id and shared by every strategy instance declaring it,
        so ``key_fn`` must be a pure function of the node's capacities
        (module-level, not a per-instance closure).

        Cost: the walk probes entries until the first fit, so it is the
        first-fit *position* in key order — O(1) for spread/worst-fit
        style keys (the best-scored node is the emptiest, which almost
        always fits) and up to O(N) for pack-style keys on a saturated
        cluster (tightest nodes first — exactly the ones least likely to
        fit). Never worse than the oracle scan it replaces, which always
        paid O(N) to build the fit list; the node-scale sweep measures a
        pack order (``bestfit``) alongside the ring to keep this
        honest."""
        self._ensure()
        order = self._orders.get(order_id)
        if order is None:
            order = _Order(order_id, key_fn, dynamic)
            order.rebuild(self._entries)
            self._orders[order_id] = order
            self.index_updates += max(len(self._entries), 1)
        elif order.key_fn is not key_fn or order.dynamic != dynamic:
            # two strategies claimed the same order id with different key
            # semantics: serving the first registrant's order would make
            # the second's indexed placement silently diverge from its
            # oracle — fail loudly instead
            raise ValueError(
                f"placement order {order_id!r} already registered with a "
                f"different key function; PlacementKey.order ids must "
                f"uniquely name their key semantics")
        order.idle_touches = 0
        for _, slot in order.items:
            st = self._entries[slot].st
            self.node_fit_ops += 1
            if _fits(st, cpus, mem, chips):
                return self._entries[slot].name
        return None

    def fit_node(self, name: str, cpus: float, mem: int, chips: int) -> bool:
        """Direct fit probe of one node (locality candidate checks)."""
        self._ensure()
        e = self._by_name.get(name)
        if e is None:
            return False
        self.node_fit_ops += 1
        return _fits(e.st, cpus, mem, chips)

    def slot_of(self, name: str) -> Optional[int]:
        self._ensure()
        e = self._by_name.get(name)
        return e.slot if e is not None else None

    # -- aggregates ------------------------------------------------------
    def max_mem_total(self) -> int:
        """Largest up-node memory — the per-round ``mem_cap``, O(1).
        0 when no up-nodes, matching ``max(..., default=0)``."""
        self._ensure()
        return self._mem_sorted[-1] if self._mem_sorted else 0

    def cluster_totals(self) -> Dict[str, float]:
        """Up-node resource totals for dominant-share accounting.

        Recomputed once per membership change, summing in registration
        order — the exact float additions of the old per-round scan over
        ``self.nodes``, so arbiter usage fractions stay bit-identical."""
        self._ensure()
        if self._totals is None:
            infos = [e.st.info for e in self._entries]
            self._totals = {
                "cpus": sum(i.cpus for i in infos),
                "mem": float(sum(i.mem_bytes for i in infos)),
                "chips": float(sum(i.chips for i in infos)),
            }
        return self._totals

    # -- introspection (leak tests / stats) ------------------------------
    def sizes(self) -> Dict[str, int]:
        self._ensure()
        return {
            "entries": len(self._entries),
            "ring": len(self._ring_entries),
            "mem_multiset": len(self._mem_sorted),
            "orders": len(self._orders),
            **{f"order_{oid}": len(o.items)
               for oid, o in self._orders.items()},
        }
