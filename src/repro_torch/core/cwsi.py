"""The Common Workflow Scheduler Interface (CWSI), v1.

The CWSI is the paper's central artifact: the *only* channel between a
workflow engine (SWMS) and the workflow-aware scheduler living inside the
resource manager. A resource manager implements the CWS once; any SWMS that
speaks CWSI gets workflow-aware scheduling on every such resource manager.

This module defines the interface as a **versioned, JSON-serialisable message
protocol** plus a server (wrapping a ``CommonWorkflowScheduler``) and a client
(used by the SWMS adapters: the simulator driver, the orchestrator, the
serving frontend). Every call crosses a ``dumps``/``loads`` boundary, so the
separation is honest — the transport could be swapped for HTTP without
touching either side. The verb surface follows Lehmann et al. (CCGrid'23):

  POST /{version}/workflow/{wid}                       register workflow
  POST /{version}/workflow/{wid}/task                  submit task (+deps)
  GET  /{version}/workflow/{wid}/task/{tid}/state      task state
  GET  /{version}/workflow/{wid}/state                 all task states
  PUT  /{version}/workflow/{wid}/strategy              choose strategy
  PUT  /{version}/workflow/{wid}/share                 set fair-share weight
  PUT  /{version}/workflow/{wid}/quota                 set queue quota
  POST /{version}/schedule                             scheduling barrier
  PUT  /{version}/clock                                advance server clock
  GET  /{version}/arbiter                              arbitration status
  PUT  /{version}/arbiter                              choose arbiter policy
  GET  /{version}/stats                                op-counter snapshot
  GET  /{version}/provenance/task/{name}               task traces
  GET  /{version}/provenance/workflow/{wid}            workflow traces
  GET  /{version}/predict/runtime                      predicted runtime
  GET  /{version}/metrics/nodes                        node utilisation

Batched scheduling
------------------
Task submissions coalesce: ``POST .../task`` asks the engine for a round
(``request_schedule``) instead of running one inline, and the pending
round executes once when the resource manager advances ``CWSIServer.clock``
past the batch's timestamp (or when its event loop drains, e.g.
``ClusterSimulator.run``). An engine built with ``sync_schedule=True``
keeps the historical round-per-submit cadence.

A resource manager *without* a clock (no virtual time to advance, no
event loop of its own) closes the batch explicitly: ``POST /schedule``
is the barrier — it drains every pending submit into one coalesced
round, runs it immediately, and returns the number of launches issued.
``GET /stats`` reports ``barrierRounds``, the count of rounds triggered
this way.

Finished workflows are *evicted* from the engine (bounded tombstones,
see ``scheduler.RetiredWorkflow``): state queries for a recently
finished workflow still answer from the tombstone (the response carries
``"retired": true``), late/duplicate completion reports are ignored,
and a tombstone that has aged out answers 404 like any unknown id.

Arbitration
-----------
The scheduler arbitrates *between* concurrent workflows (``arbiter.py``).
``PUT /workflow/{wid}/share`` with body ``{"share": <float >= 0>}`` sets a
workflow's weight: under the ``fair_share`` arbiter, running-allocation
deficits steer launches so each tenant's dominant-resource usage tracks
its share; under ``strict_priority``, higher shares preempt the queue
outright; the default ``first_appearance`` ignores shares and reproduces
the pre-arbitration ordering bit-identically. Shares may be set before
the workflow registers (tenant policy, not DAG state). ``PUT /arbiter``
with ``{"arbiter": "fair_share" | "strict_priority" |
"first_appearance"}`` switches the policy; ``GET /arbiter`` returns a
status document with the active policy, shares, per-workflow
dominant-resource usage and deficits (which sum to ~0 by construction),
per-workflow task-state counts, and the ``arbiterRounds`` /
``placementProbes`` / ``feasibilityChecks`` counters that the scale
benchmark asserts against.

Preemption and quotas
---------------------
An engine built with ``max_preemptions_per_round > 0`` reacts to share
changes at *runtime* (the CWSI paper's "future plans" item): a
``PUT .../share``, ``PUT /arbiter``, or a new tenant's arrival arms one
preemption pass, and the next scheduling round may kill-and-requeue up
to that many victim launches on over-share workflows (smallest lost
work first, never below the victim's own fair target). The killed
allocation is charged to the victim's *preemption debt* until the task
runs again, so fair share converges instead of oscillating;
``GET /arbiter`` reports ``preemptions`` / ``preemptRounds`` /
``preemptDebt`` / ``maxPreemptionsPerRound``. With the default bound of
0 the engine is bit-identical to the non-preemptive one.

``PUT /workflow/{wid}/quota`` with body
``{"maxRunning": <int >= 0 | null>, "maxQueued": <int >= 0 | null>}``
sets a per-tenant queue quota (both ``null`` clears it). ``maxRunning``
caps concurrently allocated launches — enforced where the fair-share
deficit heap emits, so the check is O(log W) — and ``maxQueued`` caps
queued tasks: a ``POST .../task`` beyond it answers **429** (policy
rejection on a well-formed request; back off and retry), mutating
nothing. Quotas appear in ``GET /arbiter`` and ``GET /stats``. As with
shares, numbers are strictly typed: NaN/inf/float/bool/string bounds
are 400s that provably mutate no state (conformance-pinned).

Abandoned registrations are reaped: a workflow registered but never
given tasks falls out of the engine after ``registration_ttl`` seconds
(a later state query answers 404, like any unknown id).

Exactly-once requests
---------------------
A client retrying a mutating call over a lossy transport cannot know
whether the lost message died before or after the server acted on it.
Any mutating request may therefore carry a client-chosen ``requestId``
(non-empty string) in its body: the id travels *inside the journaled
command*, the engine marks it in a bounded dedup window after the
command runs, and a repeat of an already-applied id is acknowledged
without re-executing (the body carries ``"duplicate": true``, or the
original response when the server still has it cached). Because the
marker rides the journal, crash recovery rebuilds the window and
exactly-once survives a restart (the cached response does not — a
post-recovery duplicate gets the generic duplicate-ack). Rejected
requests (400/404/429) are never marked, so a retry after an error
re-executes, as it must. ``core/cwsi_client.py`` packages the client
side: ids stamped per call, timeout + exponential backoff + jitter.

Every mutating route constructs a typed command record (``commands.py``)
and applies it through the engine's single ``apply`` seam, so an engine
with a write-ahead journal attached (``journal.py``) logs exactly the
CWSI's mutation history — read routes never touch the seam. The server
clock is monotonic: remote resource managers advance it with
``PUT /clock`` (body ``{"now": <seconds>}``), and backwards time is a
400 — journal replay depends on ordered timestamps. For remote SWMS
clients, ``cwsi_http.py`` fronts ``handle`` with a stdlib HTTP server
under a single-writer lock.

Error envelope: every response is ``{"status": int, "body": {...}}``;
malformed bodies are 400, unknown resources 404, quota rejections 429,
and an error response never mutates scheduler state — nor reaches the
journal (the conformance suite pins this).
"""
from __future__ import annotations

import json
import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

from . import commands as _cmd
from .dag import TaskSpec, TaskState
from .scheduler import CommonWorkflowScheduler, QuotaExceededError

CWSI_VERSION = "v1"


class CWSIError(RuntimeError):
    def __init__(self, code: int, message: str) -> None:
        super().__init__(f"CWSI {code}: {message}")
        self.code = code


@dataclass
class _Request:
    method: str
    path: str
    body: Optional[Dict[str, Any]] = None

    def encode(self) -> str:
        return json.dumps(
            {"method": self.method, "path": self.path, "body": self.body}
        )

    @staticmethod
    def decode(raw: str) -> "_Request":
        d = json.loads(raw)
        return _Request(d["method"], d["path"], d.get("body"))


class CWSIServer:
    """Resource-manager side: routes CWSI messages into the CWS engine."""

    def __init__(self, scheduler: CommonWorkflowScheduler) -> None:
        self.scheduler = scheduler
        self._clock: float = 0.0
        # scheduling rounds triggered by the POST /schedule barrier (the
        # batch-close path for resource managers without a clock)
        self.barrier_rounds = 0
        # requestId of the in-flight request, threaded into the command
        # a mutating route constructs (exactly-once dedup)
        self._request_id: Optional[str] = None

    @property
    def clock(self) -> float:
        """Virtual time, advanced by the resource manager."""
        return self._clock

    @clock.setter
    def clock(self, value: float) -> None:
        if value < self._clock:
            # journal replay depends on ordered timestamps (and every TTL
            # and trace in the engine assumes time moves forward): going
            # backwards is a driver bug, surfaced as 400 over the wire
            raise CWSIError(
                400, f"clock may not move backwards "
                     f"({value!r} < {self._clock!r})")
        if value != self._clock:
            # the clock moving closes the current submit batch: the round
            # it deferred runs at the batch's own timestamp
            self.scheduler.schedule_pending(self._clock)
        self._clock = value

    # transport entrypoint -------------------------------------------------
    def handle(self, raw_request: str) -> str:
        req = _Request.decode(raw_request)
        rid: Optional[str] = None
        try:
            if isinstance(req.body, dict) and "requestId" in req.body:
                # exactly-once: the id is transport metadata, popped off
                # before the route reads the body
                rid = req.body.pop("requestId")
                if not isinstance(rid, str) or not rid:
                    raise CWSIError(
                        400, "'requestId' must be a non-empty string")
                seen = self.scheduler._seen_requests
                if rid in seen:
                    # already applied: acknowledge without re-executing
                    # (the original envelope when still cached, else a
                    # generic duplicate-ack — e.g. after crash recovery)
                    self.scheduler.duplicate_requests += 1
                    cached = seen[rid]
                    if cached is not None:
                        return cached
                    return json.dumps({"status": 200,
                                       "body": {"duplicate": True,
                                                "requestId": rid}})
                self._request_id = rid
            status, body = self._route(req)
        except CWSIError as e:
            status, body = e.code, {"error": str(e)}
        except KeyError as e:
            status, body = 404, {"error": f"not found: {e}"}
        except QuotaExceededError as e:
            # before the plain-ValueError arm (it subclasses ValueError):
            # a quota rejection is policy, not a malformed request
            status, body = 429, {"error": str(e)}
        except ValueError as e:
            status, body = 400, {"error": str(e)}
        finally:
            self._request_id = None
        raw = json.dumps({"status": status, "body": body})
        if (status == 200 and rid is not None
                and rid in self.scheduler._seen_requests):
            # the command ran and marked the id: cache the envelope so a
            # duplicate can be answered verbatim (best-effort — evicted
            # with the window, absent after recovery)
            self.scheduler._seen_requests[rid] = raw
        return raw

    # routing ---------------------------------------------------------------
    def _route(self, req: _Request) -> Tuple[int, Dict[str, Any]]:
        if req.body is not None and not isinstance(req.body, dict):
            # valid JSON but not an object (string/array/number): every
            # route reads the body with dict accessors, so reject once here
            raise CWSIError(400, "request body must be a JSON object")
        parts = [p for p in req.path.split("/") if p]
        if not parts or parts[0] != CWSI_VERSION:
            raise CWSIError(400, f"unsupported CWSI version in path {req.path!r}")
        parts = parts[1:]
        # HTTP methods are case-insensitive on the wire: normalise once so
        # lowercase clients don't silently 404
        method = req.method.upper()

        if method == "POST" and parts[:1] == ["workflow"] and len(parts) == 2:
            wid = parts[1]
            meta = req.body or {}
            # the server clock stamps the registration so abandoned
            # (never-submitted-to) registrations age out of the engine
            self.scheduler.apply(
                _cmd.RegisterWorkflow(wid, meta.get("name", wid), meta,
                                      request_id=self._request_id),
                self.clock)
            return 200, {"workflowId": wid}

        if (method == "POST" and len(parts) == 3
                and parts[0] == "workflow" and parts[2] == "task"):
            wid = parts[1]
            body = req.body or {}
            if not isinstance(body.get("task"), dict):
                raise CWSIError(400, "body must carry a 'task' object")
            try:
                spec = TaskSpec.from_json(body["task"])
            except (KeyError, TypeError, ValueError) as e:
                raise CWSIError(400, f"malformed task object: {e}") from None
            spec.workflow_id = wid
            raw_deps = body.get("dependsOn", [])
            if not (isinstance(raw_deps, list)
                    and all(isinstance(d, str) for d in raw_deps)):
                raise CWSIError(400, "'dependsOn' must be a list of task ids")
            deps = tuple(raw_deps)
            # schedule=True folds the round request into the command:
            # batch-friendly (the engine is marked pending instead of
            # running a round per submitted task; sync_schedule engines
            # still run the round inline) and replay-exact
            task = self.scheduler.apply(
                _cmd.SubmitTask(spec, deps, schedule=True,
                                request_id=self._request_id), self.clock)
            return 200, {"taskId": task.task_id, "state": task.state.value}

        if (method == "GET" and len(parts) == 5
                and parts[0] == "workflow" and parts[2] == "task"
                and parts[4] == "state"):
            st = self.scheduler.task_state(parts[1], parts[3])
            return 200, {"state": st.value}

        if (method == "GET" and len(parts) == 3
                and parts[0] == "workflow" and parts[2] == "state"):
            dag = self.scheduler.dags.get(parts[1])
            if dag is not None:
                finished = dag.finished()
                succeeded = dag.succeeded()
                return 200, {
                    "finished": finished,
                    "succeeded": succeeded,
                    "failed": finished and not succeeded,
                    "tasks": {tid: t.state.value
                              for tid, t in dag.tasks.items()},
                }
            retired = self.scheduler.retired_workflow(parts[1])
            if retired is None:
                raise KeyError(parts[1])
            # evicted-but-remembered: answer from the bounded tombstone
            return 200, {
                "finished": True,
                "succeeded": retired.succeeded,
                "failed": not retired.succeeded,
                "tasks": dict(retired.task_states),
                "retired": True,
            }

        if method == "POST" and parts == ["schedule"]:
            # explicit scheduling barrier for RMs without a clock: close
            # the current submit batch and run ONE coalesced round now
            launched = self.scheduler.apply(
                _cmd.ScheduleBarrier(force=True,
                                     request_id=self._request_id),
                self.clock)
            self.barrier_rounds += 1
            return 200, {"launched": launched,
                         "barrierRounds": self.barrier_rounds}

        if method == "PUT" and parts == ["clock"]:
            # remote resource managers advance virtual time over the wire
            # (in-process drivers set .clock directly); the setter runs
            # any pending coalesced round and rejects backwards time
            body = req.body or {}
            t = body.get("now")
            if (isinstance(t, bool) or not isinstance(t, (int, float))
                    or not math.isfinite(t)):
                raise CWSIError(400, "body must carry a finite 'now' number")
            self.clock = float(t)
            return 200, {"clock": self._clock}

        if (method == "PUT" and len(parts) == 3
                and parts[0] == "workflow" and parts[2] == "strategy"):
            wid = parts[1]
            name = (req.body or {}).get("strategy", "")
            if not isinstance(name, str):
                # a non-string here used to reach make_strategy's dict
                # lookup and escape as an unhashable-type TypeError (a
                # 500-shaped crash); it is a client bug like any other
                raise CWSIError(400, "body must carry a 'strategy' name")
            # scoped to this workflow only — does NOT mutate the global
            # strategy other workflows are scheduled with
            self.scheduler.apply(
                _cmd.SetStrategy(wid, name, request_id=self._request_id),
                self.clock)
            return 200, {"workflowId": wid, "strategy": name}

        if (method == "PUT" and len(parts) == 3
                and parts[0] == "workflow" and parts[2] == "share"):
            wid = parts[1]
            body = req.body or {}
            if "share" not in body:
                raise CWSIError(400, "body must carry a 'share' number")
            share = self.scheduler.apply(
                _cmd.SetShare(wid, body["share"],
                              request_id=self._request_id), self.clock)
            return 200, {"workflowId": wid, "share": share}

        if (method == "PUT" and len(parts) == 3
                and parts[0] == "workflow" and parts[2] == "quota"):
            wid = parts[1]
            body = req.body or {}
            if not body:
                raise CWSIError(
                    400, "body must carry 'maxRunning' and/or 'maxQueued'")
            unknown = set(body) - {"maxRunning", "maxQueued"}
            if unknown:
                raise CWSIError(
                    400, f"unknown quota fields: {sorted(unknown)}")
            quota = self.scheduler.apply(
                _cmd.SetQuota(wid, body.get("maxRunning"),
                              body.get("maxQueued"),
                              request_id=self._request_id), self.clock)
            return 200, {"workflowId": wid,
                         "maxRunning": quota.max_running,
                         "maxQueued": quota.max_queued}

        if method == "GET" and parts == ["arbiter"]:
            return 200, self.scheduler.arbiter_status()

        if method == "PUT" and parts == ["arbiter"]:
            name = (req.body or {}).get("arbiter", "")
            if not isinstance(name, str):
                raise CWSIError(400, "body must carry an 'arbiter' name")
            arb = self.scheduler.apply(
                _cmd.SetArbiter(name, request_id=self._request_id),
                self.clock)
            return 200, {"arbiter": arb.name}

        if method == "GET" and parts == ["stats"]:
            # scheduling-overhead counters (CI asserts against these to
            # catch event-path cost regressions); read-only by contract
            stats = self.scheduler.stats()
            return 200, {
                "opCounts": self.scheduler.op_counts(),
                "schedulePending": stats["schedule_pending"],
                "running": stats["running"],
                "ready": stats["ready"],
                "retired": stats["retired"],
                "indexedNodes": stats["indexed_nodes"],
                "barrierRounds": self.barrier_rounds,
                "quotas": stats["workflow_quotas"],
                "preemptions": stats["preemptions"],
                "reapedRegistrations": stats["reaped_registrations"],
                "reapedPolicies": stats["reaped_policies"],
                "decisionLag": stats["decision_lag"],
                "tasksSettled": stats["tasks_settled"],
                "unfinishedWorkflows": stats["unfinished_workflows"],
                "journaled": stats["journaled"],
                "journalSeq": (self.scheduler.journal.seq
                               if self.scheduler.journal is not None else 0),
                "clock": self._clock,
            }

        if (method == "GET" and len(parts) == 3
                and parts[:2] == ["provenance", "task"]):
            traces = self.scheduler.provenance.traces_for_name(parts[2])
            return 200, {"traces": [
                {
                    "taskId": t.task_id, "node": t.node, "runtime": t.runtime_s,
                    "inputSize": t.input_size, "peakMem": t.peak_mem_bytes,
                    "state": t.state,
                } for t in traces
            ]}

        if (method == "GET" and len(parts) == 3
                and parts[:2] == ["provenance", "workflow"]):
            wid = parts[2]
            return 200, {
                "makespan": self.scheduler.provenance.makespan(wid),
                "queueTime": self.scheduler.provenance.total_queue_time(wid),
                "traces": len(self.scheduler.provenance.traces_for_workflow(wid)),
            }

        if method == "GET" and parts == ["predict", "runtime"]:
            body = req.body or {}
            if self.scheduler.predictor is None:
                raise CWSIError(501, "no runtime predictor installed")
            if "name" not in body:
                raise CWSIError(400, "body must carry a task 'name'")
            try:
                input_size = int(body.get("inputSize", 0))
            except (TypeError, ValueError):
                raise CWSIError(400, "'inputSize' must be an integer") from None
            mu, std = self.scheduler.predictor.predict(
                body["name"], input_size, body.get("node")
            )
            return 200, {"runtimeSeconds": mu, "stdSeconds": std}

        if method == "GET" and parts == ["metrics", "nodes"]:
            return 200, {"utilisation": self.scheduler.provenance.node_utilisation()}

        raise CWSIError(404, f"no route for {req.method} {req.path}")


class CWSIClient:
    """SWMS side: thin wrapper producing CWSI messages.

    ``transport`` is any ``str -> str`` callable; by default it is
    ``server.handle`` (in-process), but it serialises every payload so it
    can be pointed at a socket verbatim — ``cwsi_http.http_transport``
    adapts it onto a real HTTP connection with zero client changes.
    """

    def __init__(self, server: Optional[CWSIServer] = None,
                 transport: Optional[Any] = None) -> None:
        if transport is not None:
            self._transport = transport
        elif server is not None:
            self._transport = server.handle
        else:
            raise ValueError("CWSIClient needs a server or a transport")

    def _call(self, method: str, path: str,
              body: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        raw = _Request(method, f"/{CWSI_VERSION}{path}", body).encode()
        resp = json.loads(self._transport(raw))
        if resp["status"] != 200:
            raise CWSIError(resp["status"], str(resp["body"]))
        return resp["body"]

    # ---- the SWMS-facing API ----
    def register_workflow(self, workflow_id: str, name: str = "",
                          meta: Optional[Dict[str, Any]] = None) -> None:
        self._call("POST", f"/workflow/{workflow_id}",
                   {"name": name or workflow_id, **(meta or {})})

    def submit_task(self, workflow_id: str, spec: TaskSpec,
                    depends_on: Tuple[str, ...] = ()) -> str:
        body = {"task": spec.to_json(), "dependsOn": list(depends_on)}
        return self._call("POST", f"/workflow/{workflow_id}/task", body)["taskId"]

    def task_state(self, workflow_id: str, task_id: str) -> TaskState:
        b = self._call("GET", f"/workflow/{workflow_id}/task/{task_id}/state")
        return TaskState(b["state"])

    def workflow_state(self, workflow_id: str) -> Dict[str, Any]:
        return self._call("GET", f"/workflow/{workflow_id}/state")

    def set_strategy(self, workflow_id: str, strategy: str) -> None:
        self._call("PUT", f"/workflow/{workflow_id}/strategy",
                   {"strategy": strategy})

    def set_share(self, workflow_id: str, share: float) -> float:
        return self._call("PUT", f"/workflow/{workflow_id}/share",
                          {"share": share})["share"]

    def set_quota(self, workflow_id: str,
                  max_running: Optional[int] = None,
                  max_queued: Optional[int] = None) -> Dict[str, Any]:
        """Set (or, with both bounds None, clear) a tenant queue quota."""
        return self._call("PUT", f"/workflow/{workflow_id}/quota",
                          {"maxRunning": max_running,
                           "maxQueued": max_queued})

    def schedule_barrier(self) -> int:
        """Close the submit batch: run one coalesced scheduling round now
        (for resource managers that never advance the server clock)."""
        return self._call("POST", "/schedule")["launched"]

    def advance_clock(self, now: float) -> float:
        """Advance the server's virtual clock (monotonic; backwards is a
        400). Runs any pending coalesced round at the old timestamp."""
        return self._call("PUT", "/clock", {"now": now})["clock"]

    def set_arbiter(self, arbiter: str) -> str:
        return self._call("PUT", "/arbiter", {"arbiter": arbiter})["arbiter"]

    def arbiter_status(self) -> Dict[str, Any]:
        return self._call("GET", "/arbiter")

    def task_provenance(self, task_name: str) -> List[Dict[str, Any]]:
        return self._call("GET", f"/provenance/task/{task_name}")["traces"]

    def workflow_provenance(self, workflow_id: str) -> Dict[str, Any]:
        return self._call("GET", f"/provenance/workflow/{workflow_id}")

    def predict_runtime(self, name: str, input_size: int = 0,
                        node: Optional[str] = None) -> Tuple[float, float]:
        b = self._call("GET", "/predict/runtime",
                       {"name": name, "inputSize": input_size, "node": node})
        return b["runtimeSeconds"], b["stdSeconds"]

    def node_utilisation(self) -> Dict[str, float]:
        return self._call("GET", "/metrics/nodes")["utilisation"]
