"""Seconds from the process's start to the window's: importing, building
or loading the kernels, making the weights, warming up."""


def read(run):
    return run["setup_s"]
