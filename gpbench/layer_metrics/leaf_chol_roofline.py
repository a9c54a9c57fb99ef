"""The leaf Cholesky's share of its roofline, in percent: the least time
the card could take for the leaf factorizations of the traced calls over
the device time of the kernels named in ``KERNELS``.

The work comes from the configuration's leaf shapes, not from a launch:
each call factors ``B = leaves x chains`` blocks of ``m = leaf_size``,
``B m**3 / 3`` operations, reading each block's lower triangle and writing
its factor, ``B (m (m + 1) / 2 + m**2)`` elements."""

from gpbench.trace import bound_seconds

KERNELS = ("chol_kernel",)


def read(run):
    cfg = run.cell.config
    events = run.trace.kernels(lambda n: any(k in n for k in KERNELS))
    if not events or not run.calls:
        return None
    st = cfg["structure"]
    B = st["leaves"] * run.cell.traffic.get("chains", 1) * run.calls
    m = st["leaf_size"]
    size = {"float32": 4, "float64": 8}[cfg["dtype"]]
    least = bound_seconds(B * m ** 3 / 3.0,
                          B * (m * (m + 1) // 2 + m * m) * size, cfg["dtype"])
    return 100.0 * least / (sum(e["dur"] for e in events) * 1e-6)
