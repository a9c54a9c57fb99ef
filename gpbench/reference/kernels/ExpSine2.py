"""george's ``ExpSine2Kernel``: ``exp(-gamma sin(pi |d| / P)**2)``, ``P =
exp(log_period)``. Its parameters are ``gamma`` itself and ``log_period``,
in that order."""

import math

import torch

from ..kernel import Node


def _value(th, d):
    s = torch.sin(math.pi * torch.abs(d) / torch.exp(th[1]))
    return torch.exp(-th[0] * s * s)


def node(arg, build):
    return Node(["gamma", "log_period"],
                [float(arg["gamma"]), float(arg["log_period"])], _value)
