"""george's ``Matern32Kernel``: ``(1 + r) exp(-r)``, ``r = sqrt(3 d**2 / M)``
with ``M = exp(log_M)``. ``r`` is taken as ``sqrt(3 / M) |d|``, whose
derivative in ``M`` is finite at ``d = 0``."""

import torch

from ..kernel import Node, log


def _value(th, d):
    r = torch.sqrt(3.0 * torch.exp(-th[0])) * torch.abs(d)
    return (1.0 + r) * torch.exp(-r)


def node(arg, build):
    return Node(["metric:log_M_0_0"], [log(arg["metric"])], _value)
