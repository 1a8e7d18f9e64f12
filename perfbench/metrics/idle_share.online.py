"""Share of the traced stretch of the window in which no kernel or copy
ran on the card (the union of the device's intervals against the same
run's wall time)."""
from perfbench import readings


def read(run):
    if run.get("kind") != "open_loop":
        return None
    return readings.idle_share(run)
