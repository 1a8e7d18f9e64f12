"""Tokens generated in the window's rounds over the window's length (its
first round's start to its last round's end)."""


def read(run):
    if run.get("kind") != "backlog" or not run["rounds"]:
        return None
    return sum(r["active"] for r in run["rounds"]) / run["window_end"]
