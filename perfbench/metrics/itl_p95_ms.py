"""95th percentile of the gaps between a request's consecutive tokens,
over every gap that closed in the window, of every request due in it."""
from perfbench import readings


def read(run):
    if run.get("kind") != "open_loop":
        return None
    return readings.p95_ms(readings.token_gaps(run))
