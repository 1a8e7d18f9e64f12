"""The readings the limits of ``checks/`` are set from: sound runs of the
program, the control (the reference in float8,
``reference.model.Prec("fp8")``) put in the program's place, and, for
training, a fault planted in the reference (one of the two microbatches
left out, the mean taken over the rest). One process, one JSON line a
seed, each side's compared numbers and its gaps in every leaf.

    python3 perfbench/control.py --workload <name> --seeds 1,2,3 \\
        [--control-seeds 1,2] [--fault-seeds 1] [--seconds 30]

A training cell needs no window: the program's step is built and driven
through its checked steps (``drive_train``'s path), freed, and the
reference follows the same batches; the control and the fault run on the
seeds named for them. A serving cell runs the program for a window at the
cell's load (``run.py``'s path), then reads the control at the places of
its served tokens.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parents[1]), str(Path(__file__).resolve().parents[1] / "src")]

from perfbench import check, common, drive_serve, drive_train, traffic  # noqa: E402
from perfbench.reference import serve as ref_serve  # noqa: E402
from perfbench.reference import train as ref_train  # noqa: E402
from perfbench.reference.model import Prec  # noqa: E402
from perfbench.run import _environment, program_for  # noqa: E402


def _seeds(text: str):
    return [int(s) for s in text.split(",") if s]


def _free() -> None:
    import torch
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _train_seed(a, cfg_file, mix, program_cfg, seed, control, fault, device="cuda"):
    steps = mix["checked_steps"]
    batches = [traffic.train_batch(mix, seed, j, a.vocab) for j in range(steps)]
    step, state, model = drive_train.build(a, cfg_file, mix, program_cfg, seed, device)
    state, prog = drive_train.first_steps(step, state, a, cfg_file, mix, seed, device)
    del step, state, model
    _free()
    ref = check.train_reference(a, cfg_file, mix, seed, steps, device, batches=batches)
    sides = {"program": prog}
    if control:
        sides["control"] = check.train_reference(a, cfg_file, mix, seed, steps, device, "fp8",
                                                 batches)
    if fault:
        # the first row alone: microbatch 0 of the program's split
        first = [(t[:1], lab[:1]) for t, lab in batches]
        sides["microbatch_left_out"] = ref_train.run(a, cfg_file["train"], seed, first, 1,
                                                     device, Prec("f32"))
    out = {"seed": seed, "reference_loss": ref["loss"],
           "reference_grad_norm_global": ref["grad_norm_global"]}
    for name, side in sides.items():
        out[name] = check.train_compare(side, ref)
        out[name + "_leaves"] = ref_train.leaf_gaps(side["grad_norm"], ref["grad_norm"],
                                                    ref["grad_norm"])
        out[name + "_change_leaves"] = ref_train.leaf_gaps(side["change"], ref["change"],
                                                           ref["grad_norm"])
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default=None, help="default: every seed")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--seconds", type=float, default=30.0)
    args = ap.parse_args()
    _environment()

    w = common.workload(args.workload)
    cfg_file = common.config_file(w["config"])
    a, program_cfg = program_for(w["config"])
    mix = traffic.resolve(common.traffic_file(w["traffic"]))
    seeds = _seeds(args.seeds)
    control = set(seeds if args.control_seeds is None else _seeds(args.control_seeds))
    fault = set(_seeds(args.fault_seeds))
    for seed in seeds:
        if mix["kind"] == "train":
            out = _train_seed(a, cfg_file, mix, program_cfg, seed, seed in control,
                              seed in fault)
        else:
            rec = drive_serve.run(a, mix, program_cfg, seed, args.seconds, False, "cuda",
                                  lambda: None)
            out = {"seed": seed, **ref_serve.gaps(a, seed, rec["served"], "cuda",
                                                  control=Prec("fp8"))}
        print(json.dumps(out), flush=True)
        _free()
    return 0


if __name__ == "__main__":
    sys.exit(main())
