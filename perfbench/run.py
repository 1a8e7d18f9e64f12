"""Run one cell of ``BENCHMARK.json`` and print its result as one JSON line.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. Set-up (``setup_s``) runs from this
process's start to the window's: importing, building or loading the
kernels (into ``build/`` of the checkout), making the weights from the
seed on the card, warming up. The window then runs ``--seconds``; after
it, the program's state is freed and the plain reference checks what the
window's path produced (``check.py``). ``--trace 0`` reports the cell's
end-to-end metrics, ``--trace 1`` its per-layer ones from a traced
stretch of the same window. Exits 2 without a result where the card or
the cards the cell asks for are missing, 3 where a forbidden module was
loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Any, Dict, List, Optional  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _environment() -> None:
    """Caches of every compiler in fixed directories of the checkout; no
    library loads JAX; the program and the harness importable."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(ROOT / "build" / "perfbench" / sub)
    os.environ["USE_FLAX"] = "0"
    for p in (ROOT, ROOT / "src"):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))


def _reported(metrics: List[Dict[str, Any]], workload: str, end_to_end: List[str]) -> List[Dict[str, Any]]:
    """The metrics a cell reports: those that name it, and those that name
    no cells (an end-to-end one: every cell; a per-layer one: every cell
    that reports the metric it moves)."""
    out = []
    for m in metrics:
        if "workloads" in m:
            if workload in m["workloads"]:
                out.append(m)
        elif "moves" not in m or m["moves"] in end_to_end:
            out.append(m)
    return out


def program_for(config: str, smoke: bool = False):
    """→ (the configuration file's ``Arch``, the program's config set as the
    file states it); exits where the program's widths differ from the
    file's."""
    from perfbench import common
    from perfbench.arch import arch, program_config, program_mismatches
    from repro_torch.configs import get_config

    a = arch(common.config_file(config), smoke)
    program_cfg = get_config(config, smoke=smoke)
    bad = program_mismatches(a, program_cfg)
    if bad:
        raise SystemExit(f"{config}: the program's config differs from the file: {bad}")
    return a, program_config(a, program_cfg)


def run_workload(name: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
                 smoke: bool = False) -> Dict[str, Any]:
    """One run of a cell → its result (the printed line's object). ``smoke``
    takes the configuration's and the mix's ``smoke`` sizes (the CPU
    tests)."""
    _environment()
    import torch

    from perfbench import check, common, drive_serve, drive_train, traffic
    from perfbench.metrics import reader

    torch.set_num_threads(min(4, os.cpu_count() or 1))
    w = common.workload(name)
    cfg_file = common.config_file(w["config"])
    mix = traffic.resolve(common.traffic_file(w["traffic"]), smoke)
    a, program_cfg = program_for(w["config"], smoke)
    opened: Dict[str, float] = {}

    def on_window_open() -> None:
        # set-up's objects out of the collector's way during the window
        gc.collect()
        gc.freeze()
        opened["t"] = time.perf_counter()
        if device == "cuda":
            opened["setup_peak"] = torch.cuda.max_memory_allocated()

    if mix["kind"] == "train":
        rec = drive_train.run(a, cfg_file, mix, program_cfg, seed, seconds, trace, device,
                              on_window_open)
    else:
        rec = drive_serve.run(a, mix, program_cfg, seed, seconds, trace, device,
                              on_window_open)
    rec.update(setup_s=opened["t"] - T_START, arch=a, mix=mix)

    if mix["kind"] == "train":
        ref = check.train_reference(a, cfg_file, mix, seed, len(rec["checked"]["loss"]), device)
        numbers = check.train_compare(rec["checked"], ref)
    else:
        numbers = check.serve_numbers(a, seed, rec["served"], device)
    correct, shown = check.judge(numbers, check.limits_for(common.checks_file(name), smoke))

    bench = common.benchmark()
    e2e = [m["name"] for m in _reported(bench["end_to_end"], name, [])]
    wanted = (_reported(bench["per_layer"], name, e2e) if trace
              else _reported(bench["end_to_end"], name, []))
    metrics = {}
    for m in wanted:
        v = reader(m["name"])(rec)
        if v is not None and math.isfinite(v):
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev: Dict[str, Any] = {"platform": "gpu" if device == "cuda" else device,
                           "kind": torch.cuda.get_device_name(0) if device == "cuda" else device,
                           "count": w["chips"],
                           "memory_peak_bytes": max(opened.get("setup_peak", 0),
                                                    rec.get("peak_window_bytes", 0))}
    result: Dict[str, Any] = {"correct": correct, "attempted": rec["attempted"],
                              "failed": rec["failed"], "metrics": metrics, "device": dev}
    tr = rec.get("trace")
    if trace and tr is not None:
        if tr["recorded"]:
            dev.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
            result["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
        else:
            print("torch.profiler recorded no device event in the traced stretch: busy_s, "
                  "window_s, the idle shares and the breakdown are left out", file=sys.stderr)
    result["checks"] = shown
    return result


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    import torch

    from perfbench import common
    chips = common.workload(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    if args.trace:
        from perfbench import trace
        if not trace.prime():
            print("torch.profiler recorded no device event in its first sessions",
                  file=sys.stderr)
    result = run_workload(args.workload, args.seed, args.seconds, bool(args.trace))
    loaded = common.loaded_forbidden(list(sys.modules))
    if loaded:
        print(f"modules this process may not load were loaded: {loaded}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    for k, v in result["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
