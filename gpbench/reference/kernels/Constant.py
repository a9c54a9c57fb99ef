"""george's ``ConstantKernel``: ``exp(log_constant)`` at every distance."""

import torch

from ..kernel import Node, log


def node(arg, build):
    return Node(["log_constant"], [log(arg["value"])],
                lambda th, d: torch.exp(th[0]) * torch.ones_like(d))
