"""Captures of ``HODLRSolver.loglike_fn``'s CUDA graph a call: the
program's counter ``george_tpu_torch.solvers.hodlr.graph_captures`` over
the traced window, failed captures included. 1.0 where every call computes
anew and recaptures at its first gradient; a program without the counter
leaves the metric out."""

from gpbench.spans import counters

COUNTERS = counters({"graph_captures": ("george_tpu_torch.solvers.hodlr",
                                        "graph_captures")})


def read(run):
    n = run.counters.get("graph_captures")
    return None if n is None or not run.calls else n / run.calls
