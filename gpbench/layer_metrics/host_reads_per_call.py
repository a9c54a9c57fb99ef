"""Device-to-host reads a call: the program's counter
``george_tpu_torch.diagnostics.host_reads`` over the traced window."""

from gpbench.spans import counters, per_call

COUNTERS = counters({"host_reads": ("george_tpu_torch.diagnostics",
                                    "host_reads")})


def read(run):
    return per_call(run, "host_reads")
