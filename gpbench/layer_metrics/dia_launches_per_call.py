"""Launches of the DIA matvec kernel per call: the program's counter
``george_tpu_torch.ops.dia.dia_kernel_launches`` over the traced
window."""

COUNTERS = {"dia": ("george_tpu_torch.ops.dia", "dia_kernel_launches")}


def read(run):
    n = run.counters.get("dia")
    return n / run.calls if n and run.calls else None
