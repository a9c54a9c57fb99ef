"""Milliseconds a call in the span ``banded.factor`` of the banded direct
path's likelihood (``solvers/banded.py::banded_loglike_fn``): the value
table, the block-tridiagonal view and the sequential block Cholesky, its
self time. A program without the span leaves the metric out."""

from gpbench.spans import span_ms_per_call


def read(run):
    return span_ms_per_call(run, "banded.factor")
