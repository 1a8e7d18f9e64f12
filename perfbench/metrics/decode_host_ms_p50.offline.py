"""Median over the traced stretch's rounds (the program's ``batcher.round``
spans) of the host's time in the round's ``model.decode_step`` less the
waits on the card inside it: what it costs the host to enqueue one decode
step."""
from perfbench.common import percentile
from perfbench.program_spans import Spans


def read(run):
    if run.get("kind") != "backlog":
        return None
    sp = Spans()
    ms = [sp.host_ms(d) - sum(sp.host_ms(w) for w in sp.waits(d))
          for r in sp.named("batcher.round") for d in sp.below_named(r, "model.decode_step")]
    return percentile(ms, 50)
