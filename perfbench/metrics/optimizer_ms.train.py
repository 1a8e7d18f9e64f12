"""Median over the traced stretch's train steps (the program's
``train_step`` spans) of the card's time in the step's AdamW update (its
``train_step.optimizer`` span: the global norm, the clip and the update),
between CUDA events."""
from perfbench.common import percentile
from perfbench.program_spans import Spans


def read(run):
    if run.get("kind") != "train":
        return None
    sp = Spans()
    ms = [sum(sp.device_ms(o) for o in opt) for opt in
          (sp.below_named(s, "train_step.optimizer") for s in sp.named("train_step")) if opt]
    return percentile(ms, 50)
