"""The gmm's forward, dX and dW at the train microbatch's shapes, each
timed alone: least time over measured time, weighted by the step's
launches of each (gate and up D → F, down F → D: two to one)."""
from perfbench import readings


def read(run):
    if run.get("kind") != "train":
        return None
    return readings.gmm_roofline(run, {"fwd": "moe_gmm", "dx": "moe_gmm_dx",
                                       "dw": "moe_gmm_dw"})
