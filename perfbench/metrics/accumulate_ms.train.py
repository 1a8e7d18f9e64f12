"""Median over the traced stretch's train steps (the program's
``train_step`` spans) of the card's time in the step's gradient
accumulation (its ``train_step.accumulate`` spans, one a microbatch,
summed), between CUDA events."""
from perfbench.common import percentile
from perfbench.program_spans import Spans


def read(run):
    if run.get("kind") != "train":
        return None
    sp = Spans()
    ms = [sum(sp.device_ms(a) for a in acc) for acc in
          (sp.below_named(s, "train_step.accumulate") for s in sp.named("train_step")) if acc]
    return percentile(ms, 50)
