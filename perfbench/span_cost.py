"""What the program's spans (``repro_torch.spans``) cost while a profiler
records, in one process: the batch cell's decode rounds and the train
cell's steps, timed on the host's clock in short blocks taken in turns,
one block a mode a cycle, in an order that rotates from cycle to cycle.
Modes: ``spans`` (as the program has them), ``no_spans`` (every span of the
program a no-op), ``moe_in_decode`` (the MoE layers' spans opened in decode
steps too, which the program leaves out) and ``no_profiler``; the profiler
session is the one a ``--trace 1`` run opens (``trace._profile``), started
and stopped around each block. A round with an admission prefill is not
timed, nor the first round or step of a block. Then the decode rounds
again, interleaved: the profiler on (sessions of ``--per-session`` cycles,
the first untimed), the mode of the program's spans changing every round,
so that each cycle holds one round a mode (the order rotating); a cycle
with an admission is not timed. Neighbouring rounds share their work and
the host's state, so the ratio of two of them leaves out what drifts.
Prints one JSON line a part: each mode's median ms and quartiles over
every timed round or step, and, against ``no_spans``, the median and
quartiles over the cycles of each cycle's ratio (of block medians, or of
its two rounds) less 1 and the number of cycles in which the mode was
slower. A part given 0 cycles is left out. Not run by the benchmark's runs.

    python3 perfbench/span_cost.py --seed 1 [--cycles 60 --rounds 10]
        [--interleaved 900 --per-session 30]
        [--train-cycles 6 --train-steps 3] [--smoke]

``--smoke`` runs both parts on the CPU at the smoke sizes, as a rehearsal.
"""
from __future__ import annotations

import argparse
import gc
import json
import statistics
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

sys.path[:0] = [str(Path(__file__).resolve().parents[1]), str(Path(__file__).resolve().parents[1] / "src")]

from perfbench import common, drive_serve, drive_train, trace, traffic  # noqa: E402
from perfbench.run import _environment, program_for  # noqa: E402

DECODE_MODES = ("spans", "no_spans", "moe_in_decode", "no_profiler")
TRAIN_MODES = ("spans", "no_spans", "no_profiler")


class Modes:
    """Switches the program's spans by mode: the modules' own ``span`` and
    ``no_span`` names, put back by ``mode("spans")``."""

    def __init__(self) -> None:
        from repro_torch import spans
        from repro_torch.models import mamba2, moe, transformer
        from repro_torch.runtime import serve, train
        self.spans = spans
        self.moe = moe
        self.modules = (serve, transformer, moe, train, mamba2)

    def mode(self, name: str) -> None:
        sp = self.spans
        for m in self.modules:
            m.span = sp.span if name != "no_spans" else sp.no_span
        self.moe.no_span = sp.span if name == "moe_in_decode" else sp.no_span


def _quartiles(values: List[float]) -> Dict[str, float]:
    if len(values) < 2:
        return {"n": len(values), "p50": values[0] if values else None}
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return {"n": len(values), "p50": statistics.median(values), "q1": q1, "q3": q3}


def measure(fn: Callable[[], Optional[float]], modes, cycles: int, per_block: int,
            switch: Modes, device: str) -> Dict[str, object]:
    """Blocks of ``per_block`` calls of ``fn`` (→ ms, or None where the call
    is not to be timed), one a mode a cycle, the first call of a block
    untimed; → per mode the timed calls' quartiles, and against
    ``no_spans`` the cycles' ratios of block medians."""
    import torch

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    every = {m: [] for m in modes}
    blocks = {m: [] for m in modes}
    for c in range(cycles):
        for m in modes[c % len(modes):] + modes[:c % len(modes)]:
            switch.mode(m)
            prof = trace._profile(device) if m != "no_profiler" else None
            sync()
            if prof is not None:
                prof.start()
            ms = [fn() for _ in range(per_block)][1:]
            sync()
            if prof is not None:
                prof.stop()
            switch.spans.clear()
            switch.mode("spans")
            ms = [t for t in ms if t is not None]
            every[m] += ms
            blocks[m].append(statistics.median(ms) if ms else None)
    out: Dict[str, object] = {"per_call_ms": {m: _quartiles(v) for m, v in every.items()}}
    for m in modes:
        if m == "no_spans":
            continue
        ratios = [a / b - 1 for a, b in zip(blocks[m], blocks["no_spans"])
                  if a is not None and b is not None]
        out[f"{m}_vs_no_spans"] = {**_quartiles(ratios),
                                   "cycles_slower": sum(r > 0 for r in ratios)}
    return out


def interleave(fn: Callable[[], Optional[float]], modes, cycles: int, per_session: int,
               switch: Modes, device: str) -> Dict[str, object]:
    """``cycles`` cycles of one call of ``fn`` a mode, under profiler
    sessions of ``per_session`` cycles each (a session's first untimed); a
    cycle in which a call returns None is not timed. → per mode the timed
    calls' quartiles, and against ``no_spans`` each cycle's ratio."""
    import torch

    every = {m: [] for m in modes}
    ratios = {m: [] for m in modes if m != "no_spans"}
    for c in range(cycles):
        if c % per_session == 0:
            prof = trace._profile(device)
            if device == "cuda":
                torch.cuda.synchronize()
            prof.start()
        got = {}
        for m in modes[c % len(modes):] + modes[:c % len(modes)]:
            switch.mode(m)
            got[m] = fn()
        switch.mode("spans")
        switch.spans.clear()
        if c % per_session and None not in got.values():
            for m, ms in got.items():
                every[m].append(ms)
            for m in ratios:
                ratios[m].append(got[m] / got["no_spans"] - 1)
        if c % per_session == per_session - 1 or c == cycles - 1:
            if device == "cuda":
                torch.cuda.synchronize()
            prof.stop()
    out: Dict[str, object] = {"per_call_ms": {m: _quartiles(v) for m, v in every.items()}}
    for m, r in ratios.items():
        out[f"{m}_vs_no_spans"] = {**_quartiles(r), "cycles_slower": sum(x > 0 for x in r)}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--cycles", type=int, default=60, help="decode cycles")
    ap.add_argument("--rounds", type=int, default=10, help="decode rounds a block")
    ap.add_argument("--interleaved", type=int, default=900, help="interleaved decode cycles")
    ap.add_argument("--per-session", type=int, default=30,
                    help="interleaved cycles a profiler session")
    ap.add_argument("--train-cycles", type=int, default=6)
    ap.add_argument("--train-steps", type=int, default=3, help="train steps a block")
    ap.add_argument("--smoke", action="store_true", help="the CPU at the smoke sizes")
    args = ap.parse_args()
    _environment()
    import torch
    from repro_torch.runtime.serve import Request

    device = "cpu" if args.smoke else "cuda"
    if device == "cuda":
        trace.prime()
    switch = Modes()
    report: Dict[str, object] = {"card": torch.cuda.get_device_name(0) if device == "cuda" else "cpu",
                                 "seed": args.seed}

    w = common.workload("serve.mixtral-8x22b.batch")
    a, cfg = program_for(w["config"], args.smoke)
    mix = traffic.resolve(common.traffic_file(w["traffic"]), args.smoke)
    model, batcher = drive_serve.setup(a, mix, cfg, args.seed, device)
    for s in traffic.backlog(mix, args.seed, a.vocab):
        batcher.submit(Request(str(s.index), s.prompt, s.max_new_tokens))

    def round_ms() -> Optional[float]:
        p0 = batcher.prefills
        t = time.perf_counter()
        batcher.step()
        ms = (time.perf_counter() - t) * 1e3
        return ms if batcher.prefills == p0 else None

    for _ in range(2 * args.rounds):
        batcher.step()
    if args.cycles:
        report["decode_round"] = measure(round_ms, DECODE_MODES, args.cycles, args.rounds,
                                         switch, device)
        print(json.dumps(report), flush=True)
    if args.interleaved:
        report["decode_round_interleaved"] = interleave(
            round_ms, DECODE_MODES[:3], args.interleaved, args.per_session, switch, device)
        print(json.dumps(report), flush=True)
    del model, batcher
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    if not args.train_cycles:
        return 0

    w = common.workload("train.qwen3-moe-30b-a3b.4k")
    a, cfg = program_for(w["config"], args.smoke)
    mix = traffic.resolve(common.traffic_file(w["traffic"]), args.smoke)
    step, state, _ = drive_train.build(a, common.config_file(w["config"]), mix, cfg,
                                       args.seed, device)
    j = 0

    def step_ms() -> float:
        nonlocal state, j
        t = time.perf_counter()
        state, met = step(state, drive_train.batch(mix, args.seed, j, a.vocab, device))
        float(met["loss"])
        j += 1
        return (time.perf_counter() - t) * 1e3

    for _ in range(2):
        step_ms()
    report["train_step"] = measure(step_ms, TRAIN_MODES, args.train_cycles, args.train_steps,
                                   switch, device)
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
