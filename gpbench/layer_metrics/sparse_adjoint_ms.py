"""Milliseconds a call in the span ``sparse.adjoint``: the backward of the CG
solve and of the SLQ log-determinant, less the CG solves they call (their
own ``sparse.cg`` spans); its self time."""

from gpbench.spans import span_ms_per_call


def read(run):
    return span_ms_per_call(run, "sparse.adjoint")
