"""The banded (DIA) applies' share of their roofline, in percent: the least
time the card could take for the applies of the traced calls over the
device time of the kernels that made them (names in ``KERNELS``).

An apply of ``r`` columns to the ``n`` rows of a band of ``D`` diagonals
counts ``2 n D r`` operations and ``(n D + (2 r + 1) n)`` elements: the
value table, the diagonal, the input and the output, each once. ``D`` is
the band of the run's own data at the configuration's radius. Each launch
is one apply; its ``r`` is 1 for the kernel's single-column instance
(``<type, 1, 1, ...>`` in its name) and the configuration's probe count
otherwise (the CG and Lanczos blocks of the probes). A launch whose width
the name does not tell leaves the metric out."""

import re

import numpy as np

from gpbench.trace import bound_seconds

KERNELS = ("dia_stream_kernel", "dia_device_kernel")
SINGLE = re.compile(r"dia_stream_kernel<\w+, 1, 1,")
BLOCK = re.compile(r"dia_stream_kernel<\w+, \d+, \d+,")


def band(x, radius):
    """The number of diagonals of the band that holds every pair within
    ``radius`` of sorted ``x``."""
    i = np.arange(len(x))
    hi = np.searchsorted(x, x + radius, side="right") - 1 - i
    lo = np.searchsorted(x, x - radius, side="left") - i
    return int(hi.max() - lo.min() + 1)


def read(run):
    cfg = run.cell.config
    events = run.trace.kernels(lambda n: any(k in n for k in KERNELS))
    if not events:
        return None
    x = run.cell.data.x
    n, D = len(x), band(x, cfg["structure"]["band_radius"])
    probes = cfg["solver"]["options"]["num_probes"]
    size = {"float32": 4, "float64": 8}[cfg["dtype"]]
    least = 0.0
    for e in events:
        if SINGLE.search(e["name"]):
            r = 1
        elif BLOCK.search(e["name"]):
            r = probes
        else:
            return None
        least += bound_seconds(2.0 * n * D * r,
                               (n * D + (2 * r + 1) * n) * size, cfg["dtype"])
    return 100.0 * least / (sum(e["dur"] for e in events) * 1e-6)
