"""Milliseconds a call in the span ``sparse.slq``: the Lanczos steps over the
probe block and the quadrature of the log-determinant, self time."""

from gpbench.spans import span_ms_per_call


def read(run):
    return span_ms_per_call(run, "sparse.slq")
