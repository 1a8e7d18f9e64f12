"""Mean number of active slots over the window's rounds."""


def read(run):
    if run.get("kind") != "backlog" or not run["rounds"]:
        return None
    return sum(r["active"] for r in run["rounds"]) / len(run["rounds"])
