"""Milliseconds a call in the span ``hodlr.cascade`` of ``hodlr_factor``
(the float64 upward sweep: the leaf solve of the stacked skeleton factors,
each level's SMW core, its inverse and log-determinant, and the update of
the coarser factors), its self time."""

from gpbench.spans import span_ms_per_call


def read(run):
    return span_ms_per_call(run, "hodlr.cascade")
