"""Milliseconds a call in the span ``banded.solve`` of the banded direct
path's likelihood: the forward and back block substitution of the residual
and the quadratic term, its self time. A program without the span leaves
the metric out."""

from gpbench.spans import span_ms_per_call


def read(run):
    return span_ms_per_call(run, "banded.solve")
