"""Milliseconds a call in the span ``hodlr.solve`` of
``HODLRSolver.loglike_fn`` (the cascade's solve of the residual and the
quadratic term), its self time."""

from gpbench.spans import span_ms_per_call


def read(run):
    return span_ms_per_call(run, "hodlr.solve")
