"""Milliseconds a call in the span ``hodlr.backward``: the reverse sweep of
``HODLRSolver.loglike_fn``, from its result's backward to its parameters',
on the thread autograd runs it on; its self time."""

from gpbench.spans import span_ms_per_call


def read(run):
    return span_ms_per_call(run, "hodlr.backward")
