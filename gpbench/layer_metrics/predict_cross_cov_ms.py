"""Milliseconds a call in the span ``gp.predict.cross_cov``: the kernel
blocks of ``GP.predict`` evaluated on the device, copied to the host and
converted to float64; its self time."""

from gpbench.spans import span_ms_per_call


def read(run):
    return span_ms_per_call(run, "gp.predict.cross_cov")
