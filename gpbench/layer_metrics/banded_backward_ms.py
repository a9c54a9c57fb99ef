"""Milliseconds a call in the span ``banded.backward``: the reverse sweep of
the banded direct path's likelihood, from its result's backward to its
kernel parameters', on the thread autograd runs it on; its self time. A
program without the span leaves the metric out."""

from gpbench.spans import span_ms_per_call


def read(run):
    return span_ms_per_call(run, "banded.backward")
