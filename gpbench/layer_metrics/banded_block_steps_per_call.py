"""Sequential block steps the banded direct path enqueued a call: the
program's counter ``george_tpu_torch.solvers.banded.block_steps`` (one a
block in the Cholesky, two in the forward and back substitution) over the
traced window. The reverse sweep's steps are autograd's and not counted; a
program without the counter leaves the metric out."""

from gpbench.spans import counters, per_call

COUNTERS = counters({"block_steps": ("george_tpu_torch.solvers.banded",
                                     "block_steps")})


def read(run):
    return per_call(run, "block_steps")
