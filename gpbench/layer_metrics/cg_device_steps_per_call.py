"""CG steps the CUDA kernel ran a call, stopped ones included: the
program's counter ``george_tpu_torch.ops.cg.cg_device_steps`` over the
traced window. Less ``cg_iters_per_call``, it is the steps (and the
applies before them) enqueued after a solve had stopped; a program
without the counter leaves the metric out."""

from gpbench.spans import counters, per_call

COUNTERS = counters({"cg_device_steps": ("george_tpu_torch.ops.cg",
                                         "cg_device_steps")})


def read(run):
    return per_call(run, "cg_device_steps")
