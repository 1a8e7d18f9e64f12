"""Median over the traced stretch's decode rounds (the program's
``batcher.round`` spans with a ``model.decode_step`` in them) of the host's
time in the round's waits on the card: the uploads of tokens, prompts and
positions and the readback of the round's tokens."""
from perfbench.common import percentile
from perfbench.program_spans import Spans


def read(run):
    if run.get("kind") != "backlog":
        return None
    sp = Spans()
    ms = [sum(sp.host_ms(w) for w in sp.waits(r)) for r in sp.named("batcher.round")
          if sp.below_named(r, "model.decode_step")]
    return percentile(ms, 50)
