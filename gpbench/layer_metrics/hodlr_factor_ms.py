"""Milliseconds a call in the span ``hodlr.factor`` of
``HODLRSolver.loglike_fn`` (the padding of the diagonal and residual, leaf
assembly, the leaf Cholesky, the skeletons and the float64 cascade), its
self time."""

from gpbench.spans import span_ms_per_call


def read(run):
    return span_ms_per_call(run, "hodlr.factor")
