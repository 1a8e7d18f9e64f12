"""The most device memory allocated at once during the window, in GiB."""


def read(run):
    if run.get("kind") != "train" or "peak_window_bytes" not in run:
        return None
    return run["peak_window_bytes"] / 2 ** 30
