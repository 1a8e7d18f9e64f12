"""95th percentile, over the requests due in the window, of the time from
when each was due to the start of the round in which it left the
batcher's queue (the round's admission prefill follows)."""
from perfbench import readings


def read(run):
    if run.get("kind") != "open_loop":
        return None
    return readings.p95_ms(readings.queue_waits(run))
