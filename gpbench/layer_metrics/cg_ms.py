"""Milliseconds a call in the span ``sparse.cg``: every CG solve of the
sparse likelihood (the value's and those its adjoints call), self time."""

from gpbench.spans import span_ms_per_call


def read(run):
    return span_ms_per_call(run, "sparse.cg")
