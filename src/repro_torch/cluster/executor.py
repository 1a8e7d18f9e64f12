"""Real local executor: the CWS driving actual Python/JAX work.

This is the proof that the control plane is not simulation-only: the same
``CommonWorkflowScheduler`` + CWSI used by the simulator here launches real
callables (typically jitted step functions) on a thread pool, with wall-clock
time feeding the provenance store and the online predictors.

Each registered "node" is a worker lane with cpu/memory bookkeeping — on a
real deployment these lanes map to TPU slices; here they map to host threads
(the container has a single core, so lanes mostly pipeline I/O-free work).
"""
from __future__ import annotations

import threading
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional

from ..core import commands as _cmd
from ..core.dag import Task, WorkflowDAG
from ..core.scheduler import CommonWorkflowScheduler, NodeInfo, TaskResult


class LocalExecutor:
    """Implements ClusterAdapter against a thread pool and wall-clock time."""

    def __init__(self, nodes: List[NodeInfo], max_workers: Optional[int] = None):
        self._nodes = list(nodes)
        self._pool = ThreadPoolExecutor(max_workers=max_workers or len(nodes) * 2)
        self._lock = threading.RLock()          # CWS engine is not thread-safe
        self._t0 = time.monotonic()
        self._cancelled: Dict[str, bool] = {}
        # task_id -> live launch id: lets a finishing worker retire its
        # own cancel-flag entry without clobbering a relaunch's (kills —
        # speculation losers and arbiter preemptions alike — may be
        # followed by a relaunch of the same task id)
        self._launches: Dict[str, int] = {}
        self.cws: Optional[CommonWorkflowScheduler] = None
        self.outputs: Dict[str, Any] = {}

    def now(self) -> float:
        return time.monotonic() - self._t0

    def attach(self, cws: CommonWorkflowScheduler) -> None:
        self.cws = cws
        with self._lock:
            # commands through the apply seam, same as the simulator: a
            # journaled engine records this executor's history verbatim
            for n in self._nodes:
                cws.apply(_cmd.AddNode(n), self.now())

    # ---- ClusterAdapter ----
    def launch(self, task: Task, node: str, mem_alloc: int) -> None:
        # a gang launch (task.gang_nodes spans k lanes) still runs as ONE
        # worker, seated at the head lane: the engine holds the resource
        # reservations on every member, and a jitted multi-device step
        # drives all devices from a single host thread anyway
        self._cancelled[task.task_id] = False
        self._launches[task.task_id] = task.launch_id
        # capture the launch id now: the Task object is shared, so a
        # relaunch would otherwise make a stale worker report under the
        # live launch's id
        self._pool.submit(self._run, task, node, task.launch_id)

    def kill(self, task_id: str) -> None:
        # cooperative: the worker's result is discarded. A preempted
        # task may be relaunched immediately after this kill; launch()
        # then resets the flag, and the *old* worker's late report is
        # rejected by the engine on its stale launch id. A kill with no
        # tracked launch (its worker already drained) has nobody left to
        # suppress — setting the flag would leak an entry forever.
        if task_id in self._launches:
            self._cancelled[task_id] = True

    def _run(self, task: Task, node: str, launch_id: int) -> None:
        assert self.cws is not None
        with self._lock:
            self.cws.apply(_cmd.TaskStarted(task.task_id,
                                            launch_id=launch_id),
                           self.now())
        t0 = time.monotonic()
        try:
            fn = task.spec.fn
            out = fn(**task.spec.params.get("kwargs", {})) if fn else None
            ok, reason = True, ""
        except Exception as e:  # noqa: BLE001 — task failure is data here
            out, ok, reason = None, False, f"{type(e).__name__}: {e}"
            traceback.print_exc()
        cpu_s = time.monotonic() - t0
        peak = 0
        if isinstance(out, dict) and "peak_mem_bytes" in out:
            peak = int(out["peak_mem_bytes"])
        with self._lock:
            cancelled = self._cancelled.get(task.task_id)
            if self._launches.get(task.task_id) == launch_id:
                # this worker owns the live launch: retire the cancel
                # bookkeeping — cancelled or not — so the maps stay
                # bounded by in-flight work (a killed-but-never-
                # relaunched task must not leak its entries)
                self._launches.pop(task.task_id, None)
                self._cancelled.pop(task.task_id, None)
            if cancelled:
                return
            if ok:
                self.outputs[task.task_id] = out
            self.cws.apply(
                _cmd.TaskFinished(
                    task.task_id,
                    TaskResult(ok, peak_mem_bytes=peak, cpu_seconds=cpu_s,
                               reason=reason, output=out),
                    launch_id=launch_id),
                self.now())
            # wall-clock completions have no same-instant batch to
            # coalesce with: run the deferred round now rather than
            # waiting up to poll_s for the driver loop to wake
            self.cws.schedule_pending(self.now())

    # ---- driver ----
    def run_to_completion(self, dag: WorkflowDAG, poll_s: float = 0.01,
                          timeout_s: float = 600.0) -> Dict[str, Any]:
        assert self.cws is not None
        with self._lock:
            self.cws.apply(_cmd.SubmitWorkflow(dag), self.now())
        deadline = time.monotonic() + timeout_s
        while True:
            with self._lock:
                if dag.finished():
                    break
                self.cws.apply(_cmd.ScheduleBarrier(force=True), self.now())
            if time.monotonic() > deadline:
                raise TimeoutError(f"workflow {dag.workflow_id} timed out")
            time.sleep(poll_s)
        return dict(self.outputs)

    def shutdown(self) -> None:
        self._pool.shutdown(wait=True)
