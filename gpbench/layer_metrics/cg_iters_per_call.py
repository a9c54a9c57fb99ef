"""CG iterations a call: the program's counter
``george_tpu_torch.solvers.sparse.cg_iteration_count`` over the traced
window."""

from gpbench.spans import counters, per_call

COUNTERS = counters({"cg_iters": ("george_tpu_torch.solvers.sparse",
                                  "cg_iteration_count")})


def read(run):
    return per_call(run, "cg_iters")
