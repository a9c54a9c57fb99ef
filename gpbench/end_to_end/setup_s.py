"""Seconds from the start of the benchmark's process to the window:
imports, the kernels' build or load, data, ``GP.compute`` and the warm-up
calls (host clock)."""


def read(run):
    return run.setup_s
