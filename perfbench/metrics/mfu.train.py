"""The window's train steps' model FLOPs (``counts.train_step_flops``)
over the window's length and one card's dense bf16 peak, in %."""
from perfbench import counts


def read(run):
    steps = run.get("steps")
    if not steps:
        return None
    mix = run["mix"]
    flops = len(steps) * counts.train_step_flops(run["arch"], mix["sequences_per_step"],
                                                 mix["seq_len"])
    return 100.0 * flops / steps[-1]["end"] / counts.PEAK_FLOPS
