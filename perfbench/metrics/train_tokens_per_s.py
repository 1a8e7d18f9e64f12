"""Tokens trained in the window's steps over the window's length (its
first step's start to its last step's end, every step whole)."""


def read(run):
    steps = run.get("steps")
    if not steps:
        return None
    return sum(s["tokens"] for s in steps) / steps[-1]["end"]
