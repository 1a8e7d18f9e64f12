"""Model FLOPs of every prefill and decode token of the window's rounds
over the window's length and one card's dense bf16 peak, in %."""
from perfbench import counts


def read(run):
    if run.get("kind") != "backlog" or not run["rounds"]:
        return None
    a = run["arch"]
    flops = 0.0
    for r in run["rounds"]:
        flops += sum(counts.prefill_flops(a, t) for t in r["prefill_tokens"])
        flops += 2.0 * counts.matmul_params(a) * r["active"]
        flops += counts.attention_flops(a, r["decode_keys"])
    return 100.0 * flops / run["window_end"] / counts.PEAK_FLOPS
