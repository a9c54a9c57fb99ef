"""Milliseconds a call in the span ``hodlr.structure`` of
``HODLRSolver.compute``'s host set-up up to the factor (the Morton sort,
``build_structure``, the padding, the host-to-device copies of the padded
points, mask and diagonal), less the ACA pivots nested in it; its self
time."""

from gpbench.spans import span_ms_per_call


def read(run):
    return span_ms_per_call(run, "hodlr.structure")
