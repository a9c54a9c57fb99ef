"""Sequential steps of the banded direct path's hand-written reverse sweep
a call: the program's counter
``george_tpu_torch.solvers.banded.reverse_steps`` (the selected-inverse
recursion, nb - 1 a gradient) over the traced window. A program without the
counter, or whose sweep is autograd's, leaves the metric out."""

from gpbench.spans import counters, per_call

COUNTERS = counters({"reverse_steps": ("george_tpu_torch.solvers.banded",
                                       "reverse_steps")})


def read(run):
    return per_call(run, "reverse_steps")
