"""george's ``ExpSquaredKernel``: ``exp(-r2 / 2)``, ``r2 = d**2 / M`` with
``M = exp(log_M)`` (``metric`` is ``M``)."""

import torch

from ..kernel import Node, log


def node(arg, build):
    return Node(["metric:log_M_0_0"], [log(arg["metric"])],
                lambda th, d: torch.exp(-0.5 * d * d / torch.exp(th[0])))
