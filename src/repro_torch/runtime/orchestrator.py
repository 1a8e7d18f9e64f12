"""Orchestrator: the SWMS side of the CWSI for JAX training/serving jobs.

This is the paper's technique as a first-class framework feature: a training
run is not a monolithic loop but a **workflow DAG** — step-chunks chained by
dependency, with eval / checkpoint / export tasks branching off — submitted
through the CWSI so the CWS (inside the resource manager) owns ordering and
placement. Benefits inherited for free: workflow-aware priorities across
concurrent jobs, provenance of every chunk, online runtime prediction
(seeded by the roofline prior), speculative re-execution of straggling
chunks, and retry-with-doubling on OOM-failed evals.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from ..core.cwsi import CWSIClient, CWSIServer
from ..core.dag import DataRef, Resources, TaskSpec, WorkflowDAG
from ..core.predict import RooflinePrior, RooflineTerms
from ..core.scheduler import CommonWorkflowScheduler
from ..cluster.executor import LocalExecutor
from ..cluster.nodes import cpu_node


@dataclass
class TrainJobSpec:
    job_id: str
    n_steps: int
    chunk: int = 10                  # steps per workflow task
    eval_every: int = 0              # 0 = no eval tasks
    ckpt_every: int = 0
    chips: int = 0                   # chips PER NODE (0 = CPU task)
    nodes: int = 1                   # gang width: distinct nodes co-placed
    ckpt_interval_s: float = 0.0     # checkpoint cadence in task-seconds
                                     # (0 = no preemption-survivable progress)
    elastic: tuple = ()              # allowed narrower gang widths (ints < nodes)
    model_parallel: int = 1          # mesh model axis, pins resize feasibility
    roofline: Optional[RooflineTerms] = None


def _validated_elastic(spec: TrainJobSpec) -> List[int]:
    """Check every allowed width is a feasible remesh target.

    Validation happens HERE — the one layer that may touch jax — via
    ``ElasticPlan.new_mesh_shape``: a width whose device count does not
    divide by the model axis would assert at resize time inside the job,
    so reject it at workflow-build time instead. The core engine only
    ever sees the vetted integer list in ``params["elastic"]``.
    """
    from .fault import ElasticPlan   # lazy: keeps jax off the import path

    chips = max(spec.chips, 1)
    widths: List[int] = []
    for w in spec.elastic:
        if not isinstance(w, int) or isinstance(w, bool) or not 1 <= w < spec.nodes:
            raise ValueError(
                f"elastic width {w!r} invalid for a {spec.nodes}-node gang "
                f"(need an int in [1, {spec.nodes - 1}])")
        plan = ElasticPlan(spec.nodes * chips, w * chips)
        try:
            plan.new_mesh_shape(spec.model_parallel)
        except AssertionError:
            raise ValueError(
                f"elastic width {w} gives {w * chips} devices, not divisible "
                f"by model_parallel={spec.model_parallel}") from None
        widths.append(w)
    return sorted(set(widths), reverse=True)


class SharedState:
    """Mutable slot threading the train state through chained chunk tasks."""

    def __init__(self, state: Any) -> None:
        self.state = state
        self.metrics: List[Dict[str, float]] = []


def build_training_workflow(
    spec: TrainJobSpec,
    run_chunk: Callable[[SharedState, int, int], Dict[str, float]],
    shared: SharedState,
    run_eval: Optional[Callable[[SharedState, int], Dict[str, float]]] = None,
    run_ckpt: Optional[Callable[[SharedState, int], None]] = None,
) -> WorkflowDAG:
    """Compile a training job into a workflow DAG of real callables."""
    dag = WorkflowDAG(spec.job_id, f"train:{spec.job_id}")
    if spec.nodes < 1:
        raise ValueError(f"nodes must be >= 1, got {spec.nodes!r}")
    # chips is a PER-NODE request; a multi-node job asks for `nodes`
    # distinct hosts (the engine places the gang all-or-nothing) instead
    # of the old collapse of the whole gang onto one node's chip count
    res = Resources(cpus=1.0, mem_bytes=1 << 30, chips=spec.chips,
                    gang=spec.chips > 0 or spec.nodes > 1, nodes=spec.nodes)
    extra: Dict[str, Any] = {}
    if spec.ckpt_interval_s > 0:
        extra["ckpt"] = {"interval_s": float(spec.ckpt_interval_s)}
    if spec.elastic:
        if spec.nodes <= 1:
            raise ValueError("elastic widths require a multi-node gang")
        extra["elastic"] = {"allowed": _validated_elastic(spec)}
    prev: Optional[str] = None
    n_chunks = (spec.n_steps + spec.chunk - 1) // spec.chunk
    for c in range(n_chunks):
        start = c * spec.chunk
        stop = min(spec.n_steps, start + spec.chunk)
        tid = f"{spec.job_id}.chunk.{c:04d}"

        def fn(shared=shared, start=start, stop=stop):
            out = run_chunk(shared, start, stop)
            shared.metrics.append(out)
            return out

        dag.add_task(
            TaskSpec(task_id=tid, name="train_chunk",
                     inputs=(DataRef(f"state@{start}", 0),),
                     outputs=(DataRef(f"state@{stop}", 0),),
                     resources=res, fn=fn,
                     params={"kwargs": {}, **extra}),
            deps=(prev,) if prev else (),
        )
        if spec.eval_every and stop % spec.eval_every == 0 and run_eval:
            def efn(shared=shared, stop=stop):
                return run_eval(shared, stop)
            dag.add_task(
                TaskSpec(task_id=f"{spec.job_id}.eval.{c:04d}", name="eval",
                         resources=Resources(cpus=1.0), fn=efn,
                         params={"kwargs": {}}),
                deps=(tid,),
            )
        if spec.ckpt_every and stop % spec.ckpt_every == 0 and run_ckpt:
            def cfn(shared=shared, stop=stop):
                run_ckpt(shared, stop)
                return {"step": stop}
            dag.add_task(
                TaskSpec(task_id=f"{spec.job_id}.ckpt.{c:04d}",
                         name="checkpoint",
                         resources=Resources(cpus=0.5), fn=cfn,
                         params={"kwargs": {}}),
                deps=(tid,),
            )
        prev = tid
    dag.validate()
    return dag


class LocalRuntime:
    """CWS + CWSI + LocalExecutor bundle for running workflows for real."""

    def __init__(self, n_nodes: int = 2, cpus: float = 4.0,
                 strategy: str = "rank_min_rr",
                 roofline: Optional[RooflinePrior] = None) -> None:
        from ..core.predict import FeedbackMemoryPredictor, LotaruPredictor

        self.executor = LocalExecutor(
            [cpu_node(f"local-{i}", cpus=cpus, mem_gib=8)
             for i in range(n_nodes)])
        self.predictor = LotaruPredictor()
        if roofline is not None:
            roofline.seed(self.predictor)
        self.cws = CommonWorkflowScheduler(
            adapter=self.executor,
            strategy=strategy,
            predictor=self.predictor,
            mem_predictor=FeedbackMemoryPredictor(),
        )
        self.executor.attach(self.cws)
        self.server = CWSIServer(self.cws)
        self.client = CWSIClient(self.server)

    def run(self, dag: WorkflowDAG, timeout_s: float = 600.0) -> Dict[str, Any]:
        outputs = self.executor.run_to_completion(dag, timeout_s=timeout_s)
        if not dag.succeeded():
            bad = {t.task_id: t.failure_reason
                   for t in dag.tasks.values() if not t.state.terminal
                   or t.state.value != "SUCCEEDED"}
            raise RuntimeError(f"workflow failed: {bad}")
        return outputs

    def shutdown(self) -> None:
        self.executor.shutdown()
