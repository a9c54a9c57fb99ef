"""Milliseconds a call in the span ``hodlr.skeletons`` of ``hodlr_factor``
(every level's skeleton factors: the pivot entries, the ridge grams and
the float64 interpolation solves), its self time."""

from gpbench.spans import span_ms_per_call


def read(run):
    return span_ms_per_call(run, "hodlr.skeletons")
