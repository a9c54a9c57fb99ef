"""Milliseconds a call in the span ``hodlr.compute`` of
``HODLRSolver.compute`` (``hodlr_factor`` at the compute-time theta,
synchronized at its end), less the ``hodlr.skeletons`` and
``hodlr.cascade`` spans nested in it; its self time."""

from gpbench.spans import span_ms_per_call


def read(run):
    return span_ms_per_call(run, "hodlr.compute")
