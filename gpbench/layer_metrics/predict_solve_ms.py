"""Milliseconds a call in the span ``gp.predict.solve``: the solver's
``apply_inverse`` of the transposed cross-covariance (padding, the copy to
the device, the solve, the copy back); its self time."""

from gpbench.spans import span_ms_per_call


def read(run):
    return span_ms_per_call(run, "gp.predict.solve")
