"""The gmm's forward at a decode round's shapes (C = slots), timed alone:
least time over measured time, gate and up (D → F) weighted two to one
against down (F → D), as a round launches them."""
from perfbench import readings


def read(run):
    if run.get("kind") != "backlog":
        return None
    return readings.gmm_roofline(run, {"fwd": None})
