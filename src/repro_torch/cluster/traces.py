"""nf-core-shaped workflow trace generation (Fig. 2 reproduction).

The paper evaluates the CWS on "the nine most popular nf-core workflows",
each run with its test profile on a commodity Kubernetes cluster. We model
each workflow as a staged DAG template (per-sample chains, chromosome
scatters, per-sample gathers, and workflow-wide merge points — the shapes
real nf-core pipelines have) and instantiate it with seeded sample sizes.

Ground truth (runtime at unit node speed, true peak memory) is drawn ONCE at
instantiation and stored in ``spec.base_runtime_s`` / ``spec.params['sim']``,
so that different scheduling strategies are compared on *identical* DAG
instances — only the schedule differs, as in the paper's experiment.

Runtime and memory scale affinely with input size (runtime ≈ a + b·GB), the
relationship the prediction literature (Lotaru, Witt) assumes and that the
CWSI exposes for learning.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import (Any, Callable, Dict, Iterable, Iterator, List, Mapping,
                    Optional, Sequence, Tuple)

import numpy as np

from ..core import commands as _cmd
from ..core.dag import DataRef, Resources, TaskSpec, WorkflowDAG

GiB = 1 << 30


@dataclass(frozen=True)
class Stage:
    name: str
    kind: str                   # per_sample | scatter | gather | merge_all
    runtime_base_s: float       # runtime = base + per_gb * input_GB (×jitter)
    runtime_per_gb_s: float
    cpus: float = 2.0
    mem_req_gib: float = 8.0    # requested (usually over-provisioned)
    mem_base_gib: float = 1.0   # true peak = base + per_gb * input_GB
    mem_per_gb_gib: float = 0.2
    scatter: int = 1            # pieces per sample (kind == scatter)
    out_ratio: float = 0.8      # output bytes = ratio × input bytes
    jitter_sigma: float = 0.25  # per-task ground-truth lognormal spread


@dataclass(frozen=True)
class WorkflowTemplate:
    name: str
    stages: Tuple[Stage, ...]
    n_samples: int
    sample_gb_median: float
    sample_gb_sigma: float      # lognormal spread of sample sizes


def _s(name, kind, base, per_gb, **kw) -> Stage:
    return Stage(name=name, kind=kind, runtime_base_s=base,
                 runtime_per_gb_s=per_gb, **kw)


# ---------------------------------------------------------------------------
# The nine workflows of Fig. 2 (stage shapes follow the real pipelines;
# runtimes are scaled to test-profile magnitudes).
# ---------------------------------------------------------------------------
NF_CORE_TEMPLATES: Dict[str, WorkflowTemplate] = {
    "rnaseq": WorkflowTemplate("rnaseq", (
        _s("fastqc", "per_sample", 40, 12, cpus=2, mem_req_gib=6),
        _s("trimgalore", "per_sample", 60, 30, cpus=4, mem_req_gib=8),
        _s("star_align", "per_sample", 120, 90, cpus=6, mem_req_gib=20,
           mem_base_gib=16, mem_per_gb_gib=0.4),
        _s("samtools_sort", "per_sample", 30, 25, cpus=4, mem_req_gib=8),
        _s("markduplicates", "per_sample", 45, 35, cpus=3, mem_req_gib=12,
           mem_base_gib=4, mem_per_gb_gib=0.5),
        _s("salmon_quant", "per_sample", 60, 40, cpus=4, mem_req_gib=10),
        _s("qualimap", "per_sample", 35, 20, cpus=2, mem_req_gib=8),
        _s("multiqc", "merge_all", 90, 2, cpus=2, mem_req_gib=6),
    ), n_samples=10, sample_gb_median=4.0, sample_gb_sigma=0.5),

    "sarek": WorkflowTemplate("sarek", (
        _s("fastqc", "per_sample", 40, 10, cpus=2),
        _s("fastp", "per_sample", 50, 25, cpus=4),
        _s("bwa_mem", "per_sample", 150, 110, cpus=8, mem_req_gib=16,
           mem_base_gib=8, mem_per_gb_gib=0.3),
        _s("markduplicates", "per_sample", 60, 40, cpus=4, mem_req_gib=16,
           mem_base_gib=6, mem_per_gb_gib=0.4),
        _s("baserecalibrator", "scatter", 30, 18, cpus=2, scatter=6),
        _s("applybqsr", "scatter", 25, 15, cpus=2, scatter=6),
        _s("gatherbqsr", "gather", 20, 6, cpus=2),
        _s("haplotypecaller", "scatter", 70, 45, cpus=4, scatter=6,
           mem_req_gib=10),
        _s("mergevcfs", "gather", 25, 5, cpus=2),
        _s("snpeff", "per_sample", 50, 15, cpus=2, mem_req_gib=10),
        _s("multiqc", "merge_all", 80, 1.5, cpus=2),
    ), n_samples=6, sample_gb_median=8.0, sample_gb_sigma=0.6),

    "chipseq": WorkflowTemplate("chipseq", (
        _s("fastqc", "per_sample", 35, 12, cpus=2),
        _s("trimgalore", "per_sample", 55, 28, cpus=4),
        _s("bwa_mem", "per_sample", 110, 80, cpus=6, mem_req_gib=16,
           mem_base_gib=8, mem_per_gb_gib=0.3),
        _s("filter_bam", "per_sample", 40, 22, cpus=3),
        _s("macs2", "per_sample", 80, 35, cpus=2, mem_req_gib=10),
        _s("annotatepeaks", "per_sample", 45, 15, cpus=2),
        _s("consensus_peaks", "merge_all", 70, 4, cpus=3),
        _s("multiqc", "merge_all", 60, 1.5, cpus=2),
    ), n_samples=8, sample_gb_median=3.0, sample_gb_sigma=0.5),

    "atacseq": WorkflowTemplate("atacseq", (
        _s("fastqc", "per_sample", 35, 12, cpus=2),
        _s("trimgalore", "per_sample", 55, 28, cpus=4),
        _s("bowtie2", "per_sample", 120, 85, cpus=6, mem_req_gib=16,
           mem_base_gib=6, mem_per_gb_gib=0.3),
        _s("merge_library", "per_sample", 40, 20, cpus=3),
        _s("macs2", "per_sample", 75, 30, cpus=2, mem_req_gib=10),
        _s("ataqv", "per_sample", 35, 12, cpus=2),
        _s("consensus", "merge_all", 65, 3, cpus=3),
        _s("multiqc", "merge_all", 60, 1.5, cpus=2),
    ), n_samples=8, sample_gb_median=3.5, sample_gb_sigma=0.5),

    "methylseq": WorkflowTemplate("methylseq", (
        _s("fastqc", "per_sample", 35, 12, cpus=2),
        _s("trimgalore", "per_sample", 60, 30, cpus=4),
        _s("bismark_align", "per_sample", 200, 130, cpus=8, mem_req_gib=24,
           mem_base_gib=12, mem_per_gb_gib=0.5),
        _s("deduplicate", "per_sample", 50, 30, cpus=3),
        _s("methylation_extract", "per_sample", 90, 50, cpus=4, mem_req_gib=12),
        _s("bismark_report", "per_sample", 25, 8, cpus=1),
        _s("multiqc", "merge_all", 60, 1.5, cpus=2),
    ), n_samples=6, sample_gb_median=5.0, sample_gb_sigma=0.55),

    "viralrecon": WorkflowTemplate("viralrecon", (
        _s("fastqc", "per_sample", 25, 10, cpus=2),
        _s("fastp", "per_sample", 40, 20, cpus=4),
        _s("bowtie2", "per_sample", 70, 50, cpus=6, mem_req_gib=12),
        _s("ivar_trim", "per_sample", 30, 15, cpus=2),
        _s("ivar_variants", "per_sample", 45, 20, cpus=2),
        _s("ivar_consensus", "per_sample", 40, 18, cpus=2),
        _s("pangolin", "per_sample", 35, 8, cpus=2),
        _s("multiqc", "merge_all", 55, 1.5, cpus=2),
    ), n_samples=12, sample_gb_median=1.5, sample_gb_sigma=0.45),

    "mag": WorkflowTemplate("mag", (
        _s("fastqc", "per_sample", 35, 12, cpus=2),
        _s("fastp", "per_sample", 55, 28, cpus=4),
        _s("megahit_assembly", "per_sample", 350, 220, cpus=8, mem_req_gib=28,
           mem_base_gib=16, mem_per_gb_gib=1.2, jitter_sigma=0.35),
        _s("bowtie2_backmap", "per_sample", 90, 60, cpus=6, mem_req_gib=12),
        _s("metabat2_binning", "per_sample", 120, 70, cpus=4, mem_req_gib=16),
        _s("checkm", "per_sample", 150, 60, cpus=4, mem_req_gib=20),
        _s("gtdbtk", "merge_all", 200, 10, cpus=8, mem_req_gib=28),
        _s("multiqc", "merge_all", 60, 1.5, cpus=2),
    ), n_samples=5, sample_gb_median=6.0, sample_gb_sigma=0.6),

    "ampliseq": WorkflowTemplate("ampliseq", (
        _s("fastqc", "per_sample", 25, 10, cpus=2),
        _s("cutadapt", "per_sample", 35, 18, cpus=3),
        _s("dada2_filter", "per_sample", 60, 30, cpus=4, mem_req_gib=10),
        _s("dada2_denoise", "merge_all", 220, 12, cpus=8, mem_req_gib=20,
           jitter_sigma=0.3),
        _s("taxonomy", "merge_all", 140, 6, cpus=4, mem_req_gib=16),
        _s("barplots", "merge_all", 40, 2, cpus=2),
        _s("multiqc", "merge_all", 50, 1.5, cpus=2),
    ), n_samples=14, sample_gb_median=0.8, sample_gb_sigma=0.4),

    "eager": WorkflowTemplate("eager", (
        _s("fastqc", "per_sample", 30, 12, cpus=2),
        _s("adapterremoval", "per_sample", 55, 28, cpus=4),
        _s("bwa_aln", "per_sample", 140, 95, cpus=6, mem_req_gib=16,
           mem_base_gib=8, mem_per_gb_gib=0.3),
        _s("dedup", "per_sample", 45, 25, cpus=3),
        _s("damageprofiler", "per_sample", 50, 20, cpus=2),
        _s("qualimap", "per_sample", 40, 18, cpus=2),
        _s("genotyping", "per_sample", 85, 40, cpus=4, mem_req_gib=12),
        _s("multiqc", "merge_all", 60, 1.5, cpus=2),
    ), n_samples=7, sample_gb_median=3.0, sample_gb_sigma=0.65),
}

NF_CORE_WORKFLOWS: Tuple[str, ...] = tuple(NF_CORE_TEMPLATES)


def build_workflow(template: str | WorkflowTemplate, seed: int = 0,
                   workflow_id: Optional[str] = None,
                   n_samples: Optional[int] = None) -> WorkflowDAG:
    """Instantiate a template into a concrete DAG with seeded ground truth."""
    tpl = NF_CORE_TEMPLATES[template] if isinstance(template, str) else template
    rng = np.random.default_rng(seed)
    wid = workflow_id or f"{tpl.name}-s{seed}"
    dag = WorkflowDAG(wid, tpl.name)
    ns = n_samples or tpl.n_samples

    sample_gb = tpl.sample_gb_median * rng.lognormal(
        0.0, tpl.sample_gb_sigma, size=ns)

    def mk(stage: Stage, idx: str, input_gb: float,
           deps: Sequence[str]) -> Tuple[str, float]:
        jit = float(rng.lognormal(0.0, stage.jitter_sigma))
        runtime = (stage.runtime_base_s + stage.runtime_per_gb_s * input_gb) * jit
        true_peak = int((stage.mem_base_gib
                         + stage.mem_per_gb_gib * input_gb) * jit * GiB)
        req = int(stage.mem_req_gib * GiB)
        out_gb = input_gb * stage.out_ratio
        tid = f"{wid}.{stage.name}.{idx}"
        spec = TaskSpec(
            task_id=tid,
            name=stage.name,
            inputs=(DataRef(f"in:{tid}", int(input_gb * GiB)),),
            outputs=(DataRef(f"out:{tid}", int(out_gb * GiB)),),
            resources=Resources(cpus=stage.cpus, mem_bytes=req),
            params={"sim": {"peak_mem": min(true_peak, req),
                            "cpu_utilisation": 0.75}},
            base_runtime_s=runtime,
        )
        dag.add_task(spec, deps=deps)
        return tid, out_gb

    # walk stages, tracking each sample's frontier (task ids + data size)
    frontier: List[Tuple[List[str], float]] = [([], sample_gb[i]) for i in range(ns)]
    all_prev: List[str] = []
    for stage in tpl.stages:
        new_all: List[str] = []
        if stage.kind == "per_sample":
            for i in range(ns):
                deps, gb = frontier[i]
                tid, out_gb = mk(stage, f"s{i}", gb, deps)
                frontier[i] = ([tid], out_gb)
                new_all.append(tid)
        elif stage.kind == "scatter":
            for i in range(ns):
                deps, gb = frontier[i]
                tids = []
                for p in range(stage.scatter):
                    tid, _ = mk(stage, f"s{i}p{p}", gb / stage.scatter, deps)
                    tids.append(tid)
                frontier[i] = (tids, gb * stage.out_ratio)
                new_all.extend(tids)
        elif stage.kind == "gather":
            for i in range(ns):
                deps, gb = frontier[i]
                tid, out_gb = mk(stage, f"s{i}", gb, deps)
                frontier[i] = ([tid], out_gb)
                new_all.append(tid)
        elif stage.kind == "merge_all":
            deps = [t for f, _ in frontier for t in f] or all_prev
            total_gb = sum(gb for _, gb in frontier)
            tid, out_gb = mk(stage, "all", total_gb, deps)
            frontier = [([tid], out_gb / ns) for _ in range(ns)]
            new_all.append(tid)
        else:
            raise ValueError(f"unknown stage kind {stage.kind!r}")
        all_prev = new_all

    dag.validate()
    return dag


# ---------------------------------------------------------------------------
# Trace replay: streamed workflow arrivals (the "heavy traffic" regime).
#
# The paper's companion proposal argues the CWSI must hold up under
# *streams* of arriving workflows, not curated bursts. An arrival
# schedule is a plain list of descriptors (cheap: no DAGs yet); the
# replayer materialises each workflow's DAG lazily AT its arrival
# instant and submits it through the engine's command seam, so resident
# memory tracks live work — a million-task replay never holds a million
# task objects at once.
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Arrival:
    """One workflow arrival in a replayable trace (no DAG until it fires)."""

    time: float
    workflow_id: str
    template: str
    seed: int
    n_samples: Optional[int] = None
    share: Optional[float] = None       # tenant weight, declared pre-submit


def poisson_arrivals(
    n_workflows: int,
    rate: float,
    templates: Sequence[str] = NF_CORE_WORKFLOWS,
    seed: int = 0,
    n_samples: Optional[int] = None,
    share_classes: Sequence[float] = (),
) -> List[Arrival]:
    """Poisson arrival process: i.i.d. exponential gaps at ``rate``/s.

    Every workflow is its own tenant (fresh workflow id); templates cycle
    through a seeded shuffle of ``templates`` and each arrival draws its
    own ground-truth seed, so the whole trace is a pure function of
    ``seed``. ``share_classes``, when given, assigns tenant weights
    round-robin (e.g. ``(1.0, 2.0, 4.0)`` for three service classes).
    """
    if n_workflows <= 0:
        raise ValueError(f"n_workflows must be positive, got {n_workflows!r}")
    if not rate > 0:
        raise ValueError(f"rate must be positive, got {rate!r}")
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate, size=n_workflows)
    times = np.cumsum(gaps)
    picks = rng.integers(0, len(templates), size=n_workflows)
    seeds = rng.integers(0, 2**31 - 1, size=n_workflows)
    out: List[Arrival] = []
    for i in range(n_workflows):
        tpl = templates[int(picks[i])]
        out.append(Arrival(
            time=float(times[i]),
            workflow_id=f"{tpl}-r{seed}-{i:06d}",
            template=tpl,
            seed=int(seeds[i]),
            n_samples=n_samples,
            share=(share_classes[i % len(share_classes)]
                   if share_classes else None),
        ))
    return out


def burst_arrivals(
    n_bursts: int,
    burst_size: int,
    period: float,
    templates: Sequence[str] = NF_CORE_WORKFLOWS,
    seed: int = 0,
    n_samples: Optional[int] = None,
    share_classes: Sequence[float] = (),
) -> List[Arrival]:
    """Periodic same-instant bursts (cron-shaped load): ``burst_size``
    workflows land together every ``period`` seconds — the worst case for
    same-timestamp coalescing and the best case for micro-batching."""
    if n_bursts <= 0 or burst_size <= 0:
        raise ValueError("n_bursts and burst_size must be positive")
    if not period > 0:
        raise ValueError(f"period must be positive, got {period!r}")
    rng = np.random.default_rng(seed)
    n = n_bursts * burst_size
    picks = rng.integers(0, len(templates), size=n)
    seeds = rng.integers(0, 2**31 - 1, size=n)
    out: List[Arrival] = []
    for i in range(n):
        tpl = templates[int(picks[i])]
        out.append(Arrival(
            time=float((i // burst_size) * period),
            workflow_id=f"{tpl}-b{seed}-{i:06d}",
            template=tpl,
            seed=int(seeds[i]),
            n_samples=n_samples,
            share=(share_classes[i % len(share_classes)]
                   if share_classes else None),
        ))
    return out


def recorded_arrivals(records: Iterable[Mapping[str, Any]]) -> List[Arrival]:
    """Build a trace from recorded rows (e.g. a parsed JSON/CSV log):
    each row needs ``time``/``workflow_id``/``template``/``seed`` and may
    carry ``n_samples``/``share``. Rows are sorted by arrival time."""
    out = [Arrival(
        time=float(r["time"]),
        workflow_id=str(r["workflow_id"]),
        template=str(r["template"]),
        seed=int(r["seed"]),
        n_samples=(None if r.get("n_samples") is None
                   else int(r["n_samples"])),
        share=(None if r.get("share") is None else float(r["share"])),
    ) for r in records]
    out.sort(key=lambda a: a.time)
    return out


def template_task_count(template: str, n_samples: Optional[int] = None) -> int:
    """Tasks one instantiation will submit (closed-form, no DAG built)."""
    tpl = NF_CORE_TEMPLATES[template]
    ns = n_samples or tpl.n_samples
    total = 0
    for stage in tpl.stages:
        if stage.kind == "merge_all":
            total += 1
        elif stage.kind == "scatter":
            total += ns * stage.scatter
        else:
            total += ns
    return total


def trace_task_count(arrivals: Sequence[Arrival]) -> int:
    return sum(template_task_count(a.template, a.n_samples) for a in arrivals)


class TraceReplayer:
    """Streams an arrival schedule into a running simulation.

    One ``call_at`` hook is in flight at a time: each arrival builds its
    DAG (the expensive part) at its own virtual instant, declares the
    tenant's share if the trace carries one, submits the workflow through
    the engine's command seam, and chains the next arrival — so the
    replayer holds O(1) pending state no matter how long the trace is,
    and the event queue never sees the whole future schedule at once.

    ``on_arrival(now, replayer)`` (if given) fires after every submission
    — the probe benches use to sample resident-state gauges mid-replay.
    """

    def __init__(
        self,
        sim: Any,                      # ClusterSimulator (duck-typed)
        arrivals: Iterable[Arrival],
        build: Callable[..., WorkflowDAG] = build_workflow,
        on_arrival: Optional[Callable[[float, "TraceReplayer"], None]] = None,
    ) -> None:
        self._sim = sim
        self._arrivals: Iterator[Arrival] = iter(arrivals)
        self._build = build
        self._on_arrival = on_arrival
        self.submitted_workflows = 0
        self.submitted_tasks = 0
        self.last_arrival_time = 0.0

    def start(self) -> "TraceReplayer":
        """Arm the first arrival (before ``sim.run()``)."""
        self._chain_next()
        return self

    def _chain_next(self) -> None:
        nxt = next(self._arrivals, None)
        if nxt is None:
            return
        self._sim.call_at(nxt.time, lambda now, a=nxt: self._fire(a, now))

    def _fire(self, arrival: Arrival, now: float) -> None:
        cws = self._sim.cws
        dag = self._build(arrival.template, seed=arrival.seed,
                          workflow_id=arrival.workflow_id,
                          n_samples=arrival.n_samples)
        if arrival.share is not None:
            cws.apply(_cmd.SetShare(arrival.workflow_id, arrival.share), now)
        cws.apply(_cmd.SubmitWorkflow(dag), now)
        self.submitted_workflows += 1
        self.submitted_tasks += len(dag)
        self.last_arrival_time = now
        # chain AFTER submitting: the next arrival's event lands behind
        # this instant's remaining events, keeping (time, seq) order
        self._chain_next()
        if self._on_arrival is not None:
            self._on_arrival(now, self)


def workflow_summary(dag: WorkflowDAG) -> Dict[str, float]:
    ranks = dag.ranks()
    work = sum(t.spec.base_runtime_s for t in dag.tasks.values())
    cp = sum(dag.tasks[t].spec.base_runtime_s for t in dag.critical_path(
        {tid: dag.tasks[tid].spec.base_runtime_s for tid in dag.tasks}))
    return {
        "tasks": len(dag),
        "depth": max(ranks.values()),
        "total_work_s": round(work, 1),
        "critical_path_s": round(cp, 1),
        "parallelism": round(work / max(cp, 1e-9), 2),
    }
