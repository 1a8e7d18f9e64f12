"""Dry run of every (arch × shape × mesh) cell (port of
``repro.launch.dryrun``): build each cell's step on a production mesh of
256 or 512 ranks, trace one step, and write its roofline record. No
hardware and no real memory: the process group is PyTorch's ``fake``
backend (every collective returns at once), and every tensor is a fake
tensor (shapes and dtypes only) on the CPU, where each kernel entry point
takes its plain version (``repro``'s ``ATTENTION_IMPL = "naive"``).

Usage:
    python -m repro_torch.launch.dryrun --arch qwen2-7b --shape train_4k
    python -m repro_torch.launch.dryrun --arch qwen2-7b --shape train_4k --multi-pod
    python -m repro_torch.launch.dryrun --all [--both-meshes] [--skip-done] [--flash]
    python -m repro_torch.launch.dryrun --list

Each cell writes ``results/dryrun_torch/<arch>__<shape>__<mesh>.json``
(``--flash``: ``results/dryrun_torch_flash/``, the flash-attention byte
model) with ``repro``'s fields and ``status`` ``ok``/``skip``/``fail``. A
failing cell is written with its error and the run goes on.

What one traced step records, per device (``StepTrace``, a dispatch mode
that lets DTensor lower each op to its local ops first):
  * FLOPs of the local ops, by ``torch.utils.flop_counter``'s formulas;
  * each collective: kind, bytes, the group's ranks, and whether it spans
    nodes of 8 GPUs (or crosses the "pod" axis);
  * the peak bytes of local tensors made during the step, beside the
    state's own bytes per device, which the placements give exactly.
The roofline terms come from ``repro``'s analytic model at the H100's
constants (``launch.analysis``), as ``repro``'s dry run takes them.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
import traceback
import weakref
from typing import Any, Dict, List, Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from ..configs import ARCHS, SHAPES, get_config
from ..configs.base import ShapeConfig, TrainConfig
from ..models.layers import tree_leaves
from ..models.model import Model
from ..runtime.serve import make_prefill_step, make_serve_step
from ..runtime.sharding import map_tree
from ..runtime.train import make_train_step, n_microbatches
from ..shards import local_shape_and_offset
from .analysis import (
    GiB,
    HBM_BYTES,
    CollectiveOp,
    analytic_cell,
    collective_op,
    model_flops_for_cell,
    roofline_from_trace,
)
from .mesh import make_production_mesh

RESULTS_DIR = os.path.join("results", "dryrun_torch")
ATTENTION_IMPL = "naive"  # byte model for attention: naive (plain) | flash
POD_RANKS = 256           # ranks of one pod of the 2x16x16 mesh

_KINDS = {"all_reduce": "all-reduce", "all_reduce_": "all-reduce",
          "all_reduce_coalesced": "all-reduce", "all_reduce_coalesced_": "all-reduce",
          "all_gather_into_tensor": "all-gather",
          "all_gather_into_tensor_coalesced": "all-gather",
          "all_gather_into_tensor_out": "all-gather",
          "reduce_scatter_tensor": "reduce-scatter",
          "reduce_scatter_tensor_coalesced": "reduce-scatter",
          "all_to_all_single": "all-to-all", "broadcast": "broadcast",
          "broadcast_": "broadcast"}


def _nbytes(x: Any) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(t) for t in x)
    return 0


class StepTrace(TorchDispatchMode):
    """The per-device record of a traced step (see the module docstring).
    DTensor ops are handed back to DTensor (``NotImplemented``), whose local
    ops, collectives included, then come through this mode on each rank's
    local shapes. DTensor's sharding propagation runs ops of its own on
    fake tensors of the *global* shapes to learn the outputs' metadata;
    while it does, the mode counts nothing (``ShardingPropagator``'s
    ``_propagate_tensor_meta*`` methods are wrapped for the trace's span)."""

    def __init__(self, pod_ranks: Optional[int] = None) -> None:
        super().__init__()
        self.pod_ranks = pod_ranks
        self.flops = 0
        self.collectives: List[CollectiveOp] = []
        self.live = 0
        self.peak = 0
        self._seen: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
        self._paused = 0
        self._wrapped: Dict[str, Any] = {}

    def __enter__(self):
        from torch.distributed.tensor._sharding_prop import ShardingPropagator

        for name in dir(ShardingPropagator):
            if name.startswith("_propagate_tensor_meta"):
                orig = getattr(ShardingPropagator, name)
                self._wrapped[name] = orig
                setattr(ShardingPropagator, name, self._pausing(orig))
        return super().__enter__()

    def __exit__(self, *exc):
        from torch.distributed.tensor._sharding_prop import ShardingPropagator

        for name, orig in self._wrapped.items():
            setattr(ShardingPropagator, name, orig)
        self._wrapped.clear()
        return super().__exit__(*exc)

    def _pausing(self, fn):
        def wrapped(*args, **kwargs):
            self._paused += 1
            try:
                return fn(*args, **kwargs)
            finally:
                self._paused -= 1
        return wrapped

    def owns(self, tree: Any) -> None:
        """Count the local shards of ``tree`` (the state the step starts
        from, reckoned apart) as already live: not temporaries."""
        def mark(t: torch.Tensor) -> None:
            self._seen[t.to_local().untyped_storage()] = 0
        map_tree(mark, tree)

    def _track(self, out: Any) -> None:
        for t in (out if isinstance(out, (list, tuple)) else (out,)):
            if not isinstance(t, torch.Tensor) or isinstance(t, DTensor):
                continue
            st = t.untyped_storage()
            if st in self._seen:
                continue
            n = st.nbytes()
            self._seen[st] = n
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, n)

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if self._paused:
            return out
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        if func.namespace == "_c10d_functional" and packet.__name__ in _KINDS:
            self._collective(_KINDS[packet.__name__], args, out)
        self._track(out)
        return out

    def _collective(self, kind: str, args: Any, out: Any) -> None:
        group_name = args[-1]
        pg = dist.distributed_c10d._resolve_process_group(group_name)
        ranks = dist.get_process_group_ranks(pg)
        over_pod = (self.pod_ranks is not None
                    and len({r // self.pod_ranks for r in ranks}) > 1)
        nbytes = _nbytes(args[0]) if kind in ("all-reduce", "broadcast") else _nbytes(out)
        self.collectives.append(collective_op(kind, nbytes, ranks, over_pod))


def mesh_desc(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def cell_path(arch: str, shape: str, multi_pod: bool) -> str:
    return os.path.join(RESULTS_DIR, f"{arch}__{shape}__{mesh_desc(multi_pod)}.json")


def fake_sharded(spec: torch.Tensor, sharding) -> DTensor:
    """A DTensor of ``spec``'s global shape and dtype at ``sharding``, its
    local shard a fake tensor (call under ``FakeTensorMode``)."""
    mesh, pl = sharding.mesh, sharding.placements
    local_shape, _ = local_shape_and_offset(spec.shape, mesh, pl)
    local = torch.zeros(local_shape, dtype=spec.dtype, device=mesh.device_type)
    return DTensor.from_local(local, mesh, pl, run_check=False, shape=spec.shape,
                              stride=torch.empty(spec.shape, device="meta").stride())


def local_bytes(tree: Any) -> int:
    """Bytes per device of a tree of DTensors (their local shards)."""
    total = []
    map_tree(lambda t: total.append(t.to_local().numel() * t.element_size()), tree)
    return sum(total)


def build_cell(model: Model, shape: ShapeConfig, mesh: Any, multi_pod: bool,
               tcfg: TrainConfig):
    """→ (run: a function that takes one step of the cell, the tree of
    DTensors it starts from). Train cells take the train step, prefill
    cells the prefill step, decode cells the serve step, each on state made
    at its shardings (call under ``FakeTensorMode``)."""
    if shape.kind == "train":
        step, state_sh, batch_sh, state_specs = make_train_step(model, tcfg, shape, mesh,
                                                                multi_pod)
        state = map_tree(fake_sharded, state_specs, state_sh)
        batch = map_tree(fake_sharded, model.input_specs(shape), batch_sh)
        return (lambda: step(state, batch)), {"state": state, "batch": batch}
    if shape.kind == "prefill":
        step, sh, specs = make_prefill_step(model, shape, mesh, multi_pod)
        args = map_tree(fake_sharded, specs, sh)
        return (lambda: step(args)), args
    step, sh, specs = make_serve_step(model, shape, mesh, multi_pod)
    args = map_tree(fake_sharded, {k: specs[k] for k in ("params", "cache", "token")},
                    {k: sh[k] for k in ("params", "cache", "token")})
    pos = shape.seq_len - 1              # the last slot: a full cache
    return (lambda: step(args["params"], args["cache"], args["token"], pos)), args


def dry_run_cell(cfg, shape: ShapeConfig, mesh: Any, multi_pod: bool, *,
                 shape_name: str, mesh_name: str, pod_ranks: Optional[int] = None,
                 tcfg: Optional[TrainConfig] = None) -> Dict[str, Any]:
    """Trace one step of ``cfg`` at ``shape`` on ``mesh`` (a mesh over the
    ``fake`` process group) and build its record: ``repro``'s fields, the
    roofline at the H100's constants, and the traced counts."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    t0 = time.time()
    model = Model(cfg, device=mesh.device_type)
    tcfg = tcfg if tcfg is not None else TrainConfig()
    trace = StepTrace(pod_ranks)
    with FakeTensorMode(allow_non_fake_inputs=True):
        run, start = build_cell(model, shape, mesh, multi_pod, tcfg)
        state_bytes = local_bytes(start)
        trace.owns(start)
        t_build = time.time() - t0
        with trace, contextlib.ExitStack() as stack:
            if shape.kind != "train":
                stack.enter_context(torch.no_grad())
            run()
    t_trace = time.time() - t0 - t_build

    chips = math.prod(mesh.shape)
    n_micro = (n_microbatches(shape, mesh, tcfg, multi_pod)
               if shape.kind == "train" else 1)
    cache_bytes = 0
    if shape.kind == "decode":
        cache_bytes = sum(t.numel() * t.element_size() for t in
                          tree_leaves(model.cache_specs(shape.global_batch, shape.seq_len)))
    ana = analytic_cell(
        cfg, shape, chips=chips, n_micro=n_micro,
        param_bytes=model.n_params() * 2, cache_bytes=cache_bytes,
        remat=(tcfg.remat != "none"), attention_impl=ATTENTION_IMPL)
    # irreducible HBM traffic: every step must at least read the (active)
    # weights; decode must also read the cache once
    param_bytes = model.n_params() * 2
    if cfg.family == "moe" and shape.kind == "decode":
        param_bytes = cfg.active_param_count() * 2  # EP: only routed experts
    min_bytes = param_bytes + (cache_bytes if shape.kind == "decode" else 0)
    memory = {"state_bytes_per_device": state_bytes,
              "temp_peak_bytes_per_device": trace.peak}
    report = roofline_from_trace(
        trace.collectives, arch=cfg.name, shape=shape_name, mesh_desc=mesh_name,
        chips=chips, model_flops=model_flops_for_cell(cfg, shape, model), analytic=ana,
        min_bytes=float(min_bytes), traced_flops_per_device=float(trace.flops),
        memory=memory, per_device_bytes=state_bytes + trace.peak, hbm_limit=HBM_BYTES)
    return {"status": "ok", "lower_s": round(t_build, 1), "compile_s": round(t_trace, 1),
            "n_params": model.n_params(), "n_params_active": cfg.active_param_count(),
            **report.to_json()}


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             verbose: bool = True) -> Dict[str, Any]:
    """One production cell (the world must be the ``fake`` group of 256 or
    512 ranks), its record written to ``cell_path``."""
    cfg = get_config(arch)
    if shape_name in cfg.skip_shapes:
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_desc(multi_pod),
               "status": "skip", "reason": cfg.skip_reasons.get(shape_name, "")}
        _write(rec, arch, shape_name, multi_pod)
        return rec
    mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    rec = dry_run_cell(cfg, SHAPES[shape_name], mesh, multi_pod, shape_name=shape_name,
                       mesh_name=mesh_desc(multi_pod),
                       pod_ranks=POD_RANKS if multi_pod else None)
    _write(rec, arch, shape_name, multi_pod)
    if verbose:
        print(f"[dryrun] {arch} × {shape_name} × {mesh_desc(multi_pod)}: "
              f"trace {rec['compile_s']:.0f}s  compute {rec['compute_s']*1e3:.2f}ms  "
              f"memory {rec['memory_s']*1e3:.2f}ms  "
              f"collective {rec['collective_s']*1e3:.2f}ms  dominant={rec['dominant']}  "
              f"hbm/dev={rec['per_device_hbm_bytes']/GiB:.2f}GiB  "
              f"useful={rec['useful_ratio']:.2f}", flush=True)
    return rec


def _write(rec: Dict[str, Any], arch: str, shape: str, multi_pod: bool) -> None:
    os.makedirs(RESULTS_DIR, exist_ok=True)
    with open(cell_path(arch, shape, multi_pod), "w") as f:
        json.dump(rec, f, indent=1)


def start_fake_world(world_size: int) -> None:
    """The ``fake`` process group of ``world_size`` ranks, as rank 0; an
    existing group is destroyed first."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), default=None)
    ap.add_argument("--shape", choices=sorted(SHAPES), default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--skip-done", action="store_true")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--flash", action="store_true",
                    help="roofline terms under the flash-attention byte model; "
                         "results go to results/dryrun_torch_flash/")
    args = ap.parse_args(argv)
    global RESULTS_DIR, ATTENTION_IMPL
    if args.flash:
        RESULTS_DIR = os.path.join("results", "dryrun_torch_flash")
        ATTENTION_IMPL = "flash"

    if args.list:
        for a in ARCHS:
            for s in SHAPES:
                skip = s in ARCHS[a].skip_shapes
                print(f"{a:24s} {s:12s} {'SKIP' if skip else ''}")
        return 0

    if args.all:
        meshes = [False, True] if args.both_meshes else [args.multi_pod]
        cells = [(a, s, mp) for mp in meshes for a in ARCHS for s in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        cells = [(args.arch, args.shape, args.multi_pod)]

    failures = []
    world = None
    t0 = time.time()
    for a, s, mp in cells:
        if args.skip_done and os.path.exists(cell_path(a, s, mp)):
            with open(cell_path(a, s, mp)) as f:
                if json.load(f).get("status") in ("ok", "skip"):
                    continue
        if world != (512 if mp else 256):
            world = 512 if mp else 256
            start_fake_world(world)
        try:
            run_cell(a, s, mp)
        except Exception as e:  # noqa: BLE001 — a failing cell is recorded, the run goes on
            traceback.print_exc()
            _write({"status": "fail", "error": f"{type(e).__name__}: {e}",
                    "arch": a, "shape": s, "mesh": mesh_desc(mp)}, a, s, mp)
            failures.append((a, s, mp))
    if dist.is_initialized():
        dist.destroy_process_group()
    print(f"[dryrun] {len(cells)} cells in {time.time() - t0:.1f} s")
    if failures:
        print(f"[dryrun] {len(failures)} FAILURES: {failures}")
        return 1
    print("[dryrun] all cells green")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
