"""Replays of ``HODLRSolver.loglike_fn``'s CUDA graph a call: the program's
counter ``george_tpu_torch.solvers.hodlr.graph_replays`` over the traced
window. 1.0 where every value + gradient replays the captured graph, 0.0
where none does (``vmap`` over chains, a capture that failed); a program
without the counter leaves the metric out."""

from gpbench.spans import counters

COUNTERS = counters({"graph_replays": ("george_tpu_torch.solvers.hodlr",
                                       "graph_replays")})


def read(run):
    n = run.counters.get("graph_replays")
    return None if n is None or not run.calls else n / run.calls
