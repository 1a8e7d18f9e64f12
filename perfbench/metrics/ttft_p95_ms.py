"""95th percentile of time to first token over every request due in the
window, each from when it was due. A request with no token when the loop
stops counts the whole time it waited."""
from perfbench import readings


def read(run):
    if run.get("kind") != "open_loop":
        return None
    return readings.p95_ms(readings.ttfts(run))
