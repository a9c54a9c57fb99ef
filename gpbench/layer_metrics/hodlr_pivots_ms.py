"""Milliseconds a call in the span ``hodlr.aca_pivots`` of
``HODLRSolver.compute`` (``select_aca_pivots``: the kernel-adaptive
skeleton pivots, chosen on the host in float64), nested in
``hodlr.structure``; its self time."""

from gpbench.spans import span_ms_per_call


def read(run):
    return span_ms_per_call(run, "hodlr.aca_pivots")
