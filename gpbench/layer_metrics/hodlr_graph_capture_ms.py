"""Milliseconds a call in the span ``hodlr.graph_capture`` of
``HODLRSolver._graph_value_and_grad`` (the CUDA graph of the value and
gradient, captured at the first gradient after each ``compute``: a
side-stream warm-up, the capture and a checking replay), less the eager
sweeps' spans nested in it; its self time."""

from gpbench.spans import span_ms_per_call


def read(run):
    return span_ms_per_call(run, "hodlr.graph_capture")
