"""george's ``WendlandC2Kernel``: the base kernel tapered by ``(1 - u)**4
(4 u + 1)`` for ``u = |d| / rc < 1`` and 0 beyond, ``rc = exp(log_rc)``."""

import torch

from ..kernel import Node


def node(arg, build):
    base = build(arg["kernel_base"])

    def value(th, d):
        u = torch.abs(d) / torch.exp(th[0])
        uc = torch.clamp(u, max=1.0)
        taper = torch.where(u < 1.0, (1.0 - uc) ** 4 * (4.0 * uc + 1.0),
                            torch.zeros_like(u))
        return taper * base.fn(th[1:], d)

    return Node(["log_rc"] + ["kernel_base:" + s for s in base.names],
                [float(arg["log_rc"])] + base.theta0, value)
