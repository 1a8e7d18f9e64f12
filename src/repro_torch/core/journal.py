"""Write-ahead journal + crash recovery for the CWS engine.

The durability story the CWSI positions the scheduler for (the resource
manager restarts without draining its cluster) rests on three pieces:

* **Append-only JSONL log.** Every command entering
  ``CommonWorkflowScheduler.apply`` is appended *before* it runs
  (write-ahead: the log always covers at least what the engine has
  done). Line 1 is a config record pinning the engine's construction —
  strategy/arbiter/predictor names and every scalar knob — written
  lazily at the first append so post-construction wiring (e.g. the
  simulator overriding ``staging_bandwidth`` on attach) is captured.
  Entry lines are ``{"seq": n, "t": now, "cmd": kind, "args": {...}}``,
  framed by the journal with the args fragment pre-encoded by the
  command (``Command.wire_args`` — the hot-path commands hand-build it).

* **Snapshots + compaction.** With ``snapshot_every=N`` the journal
  pickles the whole engine to ``<path>.snap`` every N entries (atomic
  tmp + rename) and compacts the log back to its config record, so both
  files stay bounded by live state, not history. The pickle excludes the
  adapter/journal/callbacks (see ``CommonWorkflowScheduler.__getstate__``).

* **``recover(path)``.** Load the snapshot if one exists (else build a
  fresh engine from the config record), re-apply the tail entries
  through the very same ``apply`` seam, and reattach a journal in append
  mode. Because every mutation flows through the closed command set and
  all engine iteration orders are deterministic, the recovered engine is
  **bit-identical**: same ``(task, node, start)`` decision traces, same
  ``op_counts()`` (pinned by tests/test_journal.py and the bench's
  ``recovery_traces_identical`` flag). A torn final line — the crash
  landing mid-write — is detected, ignored, and truncated on reattach.

Attach the journal **before the first mutation**: commands applied
earlier (shares declared before ``attach``, say) never reach the log, so
a full-log replay rebuilds an engine that never saw them. The config
record covers construction *knobs* only, not command history.

Known limit: speculative-copy ids come from a module-global counter
(``dag.fresh_task_id``) that is not engine state, so snapshot-based
recovery of an ``enable_speculation`` engine can mint different copy ids
than the uninterrupted run (full-log replay in a fresh process is still
identical). The identity guarantees above are stated for the default
speculation-off engine.
"""
from __future__ import annotations

import json
import mmap
import os
import pickle
from typing import Any, Dict, List, Optional, Tuple

from . import commands as _cmd
from .predict import FeedbackMemoryPredictor, LotaruPredictor
from .provenance import ProvenanceStore
from .scheduler import CommonWorkflowScheduler

_PREDICTORS = {
    "LotaruPredictor": LotaruPredictor,
    "FeedbackMemoryPredictor": FeedbackMemoryPredictor,
}


class _NullAdapter:
    """Replay adapter: launches/kills already happened in the real world
    (or will be re-driven by the recovering resource manager)."""

    def launch(self, task, node, mem_alloc) -> None:
        pass

    def kill(self, task_id) -> None:
        pass


def engine_config(cws: CommonWorkflowScheduler) -> Dict[str, Any]:
    """The construction record: everything a fresh process needs to build
    an equivalent engine before replaying commands into it. Policies are
    recorded by registry name — a journaled engine must use named
    strategies/arbiters/predictors, not anonymous objects."""
    return {
        "strategy": cws.strategy.name,
        "arbiter": cws.arbiter.name,
        "predictor": type(cws.predictor).__name__ if cws.predictor else None,
        "memPredictor": (type(cws.mem_predictor).__name__
                         if cws.mem_predictor else None),
        "enableSpeculation": cws.enable_speculation,
        "speculationFactor": cws.speculation_factor,
        "speculationMinRuntime": cws.speculation_min_runtime,
        "stagingBandwidth": cws.staging_bandwidth,
        "usePredictedMemory": cws.use_predicted_memory,
        "legacyScan": cws.legacy_scan,
        "syncSchedule": cws.sync_schedule,
        "decisionLag": cws.decision_lag,
        "provenanceRetention": cws.provenance.retention,
        "maxPreemptionsPerRound": cws.max_preemptions_per_round,
        "retireFinished": cws.retire_finished,
        "retiredMax": cws.retired_max,
        "registrationTtl": cws.registration_ttl,
        "reportLease": cws.report_lease,
        "quarantineThreshold": cws.quarantine_threshold,
        "quarantineDuration": cws.quarantine_duration,
        "retryAntiAffinity": cws.retry_anti_affinity,
        "requestDedupWindow": cws.request_dedup_window,
    }


def _build_engine(config: Dict[str, Any], adapter: Any) -> CommonWorkflowScheduler:
    pred = _PREDICTORS.get(config.get("predictor") or "")
    mem = _PREDICTORS.get(config.get("memPredictor") or "")
    return CommonWorkflowScheduler(
        adapter=adapter,
        strategy=config["strategy"],
        provenance=ProvenanceStore(
            retention=config.get("provenanceRetention")),
        predictor=pred() if pred else None,
        mem_predictor=mem() if mem else None,
        enable_speculation=config.get("enableSpeculation", False),
        speculation_factor=config.get("speculationFactor", 1.8),
        speculation_min_runtime=config.get("speculationMinRuntime", 30.0),
        staging_bandwidth=config.get("stagingBandwidth", 1e9),
        use_predicted_memory=config.get("usePredictedMemory", False),
        legacy_scan=config.get("legacyScan", False),
        sync_schedule=config.get("syncSchedule", False),
        decision_lag=config.get("decisionLag", 0.0),
        arbiter=config["arbiter"],
        retire_finished=config.get("retireFinished", True),
        retired_max=config.get("retiredMax", 256),
        max_preemptions_per_round=config.get("maxPreemptionsPerRound", 0),
        registration_ttl=config.get("registrationTtl", 3600.0),
        report_lease=config.get("reportLease"),
        quarantine_threshold=config.get("quarantineThreshold", 0),
        quarantine_duration=config.get("quarantineDuration", 300.0),
        retry_anti_affinity=config.get("retryAntiAffinity", False),
        request_dedup_window=config.get("requestDedupWindow", 1024),
    )


def _scan(path: str) -> Tuple[Optional[Dict[str, Any]],
                              List[Tuple[int, float, str, Dict[str, Any]]],
                              int]:
    """Parse an existing journal: (config, entries, clean_byte_length).

    Stops at the first unparseable line — a torn tail from a crash
    mid-append — and reports how many bytes ARE clean so a reattach can
    truncate the wreckage. The write-ahead order makes dropping a torn
    final entry safe: its command never ran."""
    config: Optional[Dict[str, Any]] = None
    entries: List[Tuple[int, float, str, Dict[str, Any]]] = []
    clean = 0
    if not os.path.exists(path):
        return config, entries, clean
    with open(path, "rb") as fh:
        for raw in fh:
            if not raw.endswith(b"\n"):
                break                       # torn: no newline ever landed
            try:
                rec = json.loads(raw)
            except ValueError:
                break                       # torn mid-line
            if "config" in rec:
                config = rec["config"]
            elif "cmd" in rec:
                entries.append((int(rec["seq"]), float(rec["t"]),
                                rec["cmd"], rec.get("args") or {}))
            else:
                break                       # unrecognised: treat as torn
            clean += len(raw)
    return config, entries, clean


def read_commands(path: str) -> List[Tuple[int, float, _cmd.Command]]:
    """Decode a journal's clean entries back into live command objects
    (the chaos harness replays reference-journal tails through this)."""
    _, entries, _ = _scan(path)
    return [(seq, t, _cmd.decode(kind, args))
            for seq, t, kind, args in entries]


class Journal:
    """Append-only write-ahead log over one engine (see module docstring).

    ``snapshot_every=0`` (default) disables snapshots — the log grows
    with history and recovery replays it in full. ``fsync=True`` forces
    the entry to disk before apply runs (real-crash durability); the
    default flushes to the OS only, which the bench's overhead budget is
    measured against.
    """

    #: preallocation quantum for the mmap'd live segment
    CHUNK = 1 << 20

    def __init__(self, path: str, snapshot_every: int = 0,
                 fsync: bool = False) -> None:
        self.path = str(path)
        self.snapshot_every = snapshot_every
        self.fsync = fsync
        self.seq = 0
        self._seq0 = 0                      # seq when this attach began
        self._snap_seq = 0                  # seq at the last snapshot
        self.snapshots = 0
        self.compactions = 0
        self._engine: Optional[CommonWorkflowScheduler] = None
        self._fd = -1
        self._mm: Optional[mmap.mmap] = None
        self._end = 0                       # bytes of real content
        self._cap = 0                       # preallocated file size
        self._config: Optional[Dict[str, Any]] = None
        self._t_key = None                  # last timestamp repr'd
        self._t_repr = b""

    @property
    def snap_path(self) -> str:
        return self.path + ".snap"

    @property
    def appends(self) -> int:
        """Entries appended since this journal attached."""
        return self.seq - self._seq0

    def attach(self, cws: CommonWorkflowScheduler) -> "Journal":
        """Wire this journal under an engine's apply seam.

        Reattaching over an existing log resumes its sequence (any torn
        tail is overwritten in place and gone by ``close``); the config
        record is written lazily at the first append so late engine
        wiring (e.g. the simulator patching ``staging_bandwidth``) is
        captured."""
        config, entries, clean = _scan(self.path)
        if config is not None or entries:
            self._config = config
            self.seq = entries[-1][0] if entries else 0
        self._seq0 = self._snap_seq = self.seq
        # The live segment is an mmap over a chunk-preallocated file:
        # entry stores are plain memcpys straight into the page cache,
        # which is the same process-crash durability as an unbuffered
        # write(2) at ~a third of the cost (the bench's overhead budget).
        # The NUL padding past ``_end`` reads as a torn tail (_scan
        # stops at it) and ``close`` truncates it away.
        self._fd = os.open(self.path, os.O_RDWR | os.O_CREAT, 0o644)
        self._end = clean
        self._cap = 0
        self._ensure(1)                     # also zeroes [clean:cap] —
        self._engine = cws                  # torn wreckage is gone here
        cws.journal = self
        return self

    def _ensure(self, need: int) -> None:
        """Grow the preallocated segment (and remap) to fit ``need``."""
        cap = self._cap
        while cap < self._end + need:
            cap += self.CHUNK
        os.ftruncate(self._fd, cap)
        if self._mm is not None:
            self._mm.close()
        self._mm = mmap.mmap(self._fd, cap)
        self._cap = cap
        # Pre-touch the whole slack region with explicit NULs. This does
        # two jobs at once: any torn wreckage past ``_end`` can never
        # read back as a live line, and — the perf half — every page the
        # appends will land on is faulted in and resident NOW, at
        # (re)attach/growth time, instead of one minor fault per 4 KiB
        # sprinkled across the append hot path (page allocation under a
        # loaded host is the single most contention-sensitive cost the
        # journal has).
        self._mm[self._end:cap] = bytes(cap - self._end)
        # the mmap position is the write cursor (mm.write is a third
        # the cost of a slice assignment on the append hot path)
        self._mm.seek(self._end)

    def append(self, t: float, cmd: _cmd.Command) -> int:
        if self._mm is None:
            raise RuntimeError("journal is not attached")
        if self._config is None:
            self._config = engine_config(self._engine)
            self._write({"seq": 0, "config": self._config})
        if not self.fsync:
            # the attach/config checks above only matter once: shadow
            # this method with the bare hot path for every later append
            # (``close`` removes the shadow)
            self.append = self._fast_append
            return self._fast_append(t, cmd)
        seq = self._fast_append(t, cmd)
        self._mm.flush()
        os.fsync(self._fd)
        return seq

    def _fast_append(self, t: float, cmd: _cmd.Command) -> int:
        # the per-task hot path — every op here is paid ~4k times per
        # bench burst (the journal_overhead_pct budget)
        seq = self.seq = self.seq + 1
        if t != self._t_key:                # coalesced rounds repeat the
            self._t_key = t                 # timestamp; float(): sim
            self._t_repr = repr(float(t)).encode()  # np.float64 repr is
        # the command builds the whole entry line   # not JSON; cache it
        # as bytes in one hand-framed pass (the generic dict-then-dumps
        # route costs ~3x more)
        data = cmd.wire_line(seq, self._t_repr)
        n = self._end + len(data)
        if n > self._cap:
            self._ensure(len(data))
        self._mm.write(data)
        self._end = n
        return seq

    def _write(self, rec: Dict[str, Any]) -> None:
        data = json.dumps(rec, sort_keys=True).encode() + b"\n"
        if self._end + len(data) > self._cap:
            self._ensure(len(data))
        self._mm.write(data)
        self._end += len(data)
        if self.fsync:
            self._mm.flush()
            os.fsync(self._fd)

    def maybe_snapshot(self, cws: CommonWorkflowScheduler) -> bool:
        if self.snapshot_every <= 0 \
                or self.seq - self._snap_seq < self.snapshot_every:
            return False
        self.snapshot(cws)
        return True

    def snapshot(self, cws: CommonWorkflowScheduler) -> None:
        """Pickle the engine at the current seq, then compact the log.

        The snapshot lands atomically (tmp + rename) BEFORE the log is
        rewritten, so a crash between the two leaves a snapshot plus a
        longer-than-needed log — recovery skips entries ≤ snap seq."""
        if self._config is None:
            self._config = engine_config(cws)
        tmp = self.snap_path + ".tmp"
        with open(tmp, "wb") as fh:
            pickle.dump({"seq": self.seq, "config": self._config,
                         "engine": cws}, fh)
        os.replace(tmp, self.snap_path)
        self.snapshots += 1
        # compaction: the log restarts at the config record; history up
        # to seq now lives only in the snapshot
        self._end = 0
        self._mm.seek(0)
        self._write({"seq": 0, "config": self._config,
                     "compactedTo": self.seq})
        # zero the stale history past the new end so it cannot read as
        # live entries (it would otherwise still parse)
        self._mm[self._end:self._cap] = b"\x00" * (self._cap - self._end)
        self.compactions += 1
        self._snap_seq = self.seq

    def close(self) -> None:
        self.__dict__.pop("append", None)   # restore the checked method
        if self._mm is not None:
            self._mm.flush()
            self._mm.close()
            self._mm = None
        if self._fd >= 0:
            os.ftruncate(self._fd, self._end)   # drop the NUL padding
            os.close(self._fd)
            self._fd = -1
        if self._engine is not None and self._engine.journal is self:
            self._engine.journal = None
        self._engine = None


def recover(journal_path: str, adapter: Any = None, journal: bool = True,
            snapshot_every: int = 0, fsync: bool = False,
            ) -> CommonWorkflowScheduler:
    """Rebuild a bit-identical engine from ``journal_path``.

    Loads ``<path>.snap`` if present (skipping entries it already
    covers), else constructs a fresh engine from the log's config
    record; replays the remaining entries through ``apply`` with no
    journal attached (replay must not re-log itself); then — unless
    ``journal=False`` — reattaches a ``Journal`` in append mode so the
    recovered engine keeps journaling where the dead one stopped.
    """
    config, entries, _ = _scan(journal_path)
    engine: Optional[CommonWorkflowScheduler] = None
    start_seq = 0
    snap_path = journal_path + ".snap"
    if os.path.exists(snap_path):
        with open(snap_path, "rb") as fh:
            snap = pickle.load(fh)
        engine = snap["engine"]
        config = snap["config"]
        start_seq = snap["seq"]
    if engine is None:
        if config is None:
            raise ValueError(
                f"journal {journal_path!r} has no config record and no "
                f"snapshot: nothing to recover")
        engine = _build_engine(config, adapter)
    engine.adapter = adapter if adapter is not None else _NullAdapter()
    for seq, t, kind, args in entries:
        if seq <= start_seq:
            continue
        engine.apply(_cmd.decode(kind, args), t)
    if journal:
        Journal(journal_path, snapshot_every=snapshot_every,
                fsync=fsync).attach(engine)
    return engine
