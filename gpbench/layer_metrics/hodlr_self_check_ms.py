"""Milliseconds a call in the span ``hodlr.self_check`` of
``HODLRSolver.compute`` (the factorization's one-probe residual, a solve
and a compressed matvec read to the host; a configuration already checked
in the process skips it); its self time."""

from gpbench.spans import span_ms_per_call


def read(run):
    return span_ms_per_call(run, "hodlr.self_check")
