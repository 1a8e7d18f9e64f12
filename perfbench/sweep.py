"""Find an open-loop cell's knee: the highest arrival rate the program
sustains. One set-up, then one window a rate, each printed as a JSON line
(time to first token, queue wait, the queue at the window's end, tokens a
second completed). Not run by the benchmark's runs; the knee is written
into the traffic file as a number, once.

    python3 perfbench/sweep.py --workload serve.mixtral-8x22b.chat --rates 2,3,4,5 --seconds 30 --seed 1
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parents[1]), str(Path(__file__).resolve().parents[1] / "src")]

from perfbench import common, drive_serve, readings, traffic  # noqa: E402
from perfbench.run import _environment, program_for  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()
    _environment()
    import torch

    w = common.workload(args.workload)
    a, cfg = program_for(w["config"])
    mix = traffic.resolve(common.traffic_file(w["traffic"]))
    model, batcher = drive_serve.setup(a, mix, cfg, args.seed, "cuda")
    for rate in (float(r) for r in args.rates.split(",")):
        m = {**mix, "rate_per_s": rate}
        specs = traffic.open_loop(m, args.seed, args.seconds, a.vocab)
        rec, reqs = drive_serve.window(a, m, model, batcher, specs, args.seconds, False, "cuda")
        rec["seconds"] = args.seconds
        due = [r for r in rec["requests"] if r["due"] < args.seconds]
        at_end = sum(1 for r in due if r["left_queue"] is None or r["left_queue"] > args.seconds)
        toks = sum(1 for r in rec["requests"] for t in r["tokens"] if t <= args.seconds)
        print(json.dumps({
            "rate_per_s": rate, "requests": len(due),
            "ttft_p50_ms": 1e3 * common.percentile(readings.ttfts(rec), 50),
            "ttft_p95_ms": readings.p95_ms(readings.ttfts(rec)),
            "itl_p95_ms": readings.p95_ms(readings.token_gaps(rec)),
            "queue_wait_p95_ms": readings.p95_ms(readings.queue_waits(rec)),
            "queued_at_window_end": at_end, "tokens_per_s": toks / args.seconds}), flush=True)
        # the next rate starts from an empty batcher
        batcher.slots = [None] * len(batcher.slots)
        batcher.queue.clear()
        batcher.pos[:] = 0
        del reqs
        torch.cuda.synchronize()
    return 0


if __name__ == "__main__":
    sys.exit(main())
