"""Median host time of a round with no admission prefill in it (the
decode step of every slot, with the host's work around it)."""
from perfbench.common import percentile


def read(run):
    if run.get("kind") != "open_loop":
        return None
    ms = [(r["end"] - r["start"]) * 1e3 for r in run["rounds"] if not r["prefill"]]
    return percentile(ms, 50)
