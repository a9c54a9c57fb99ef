"""A configuration's kernel spec as a plain function of its parameters.

A spec is a one-key JSON object: ``{"sum": [a, b]}`` and ``{"product":
[a, b]}`` combine two specs, ``{"scale": [c, a]}`` is ``c * a`` (george
lifts the scalar to a ``ConstantKernel``), and ``{"<Name>": {...}}`` is the
kernel of ``reference/kernels/<Name>.py``. Parameter names and their order
follow george's (``k1:``/``k2:`` prefixes of a binary operator), so that a
parameter vector means the same to the reference and to the program.
"""

import importlib
import math
from collections import namedtuple

Node = namedtuple("Node", "names theta0 fn")


def _combine(a, b, op):
    na = len(a.names)
    return Node(["k1:" + s for s in a.names] + ["k2:" + s for s in b.names],
                a.theta0 + b.theta0,
                lambda th, d: op(a.fn(th[:na], d), b.fn(th[na:], d)))


def build(spec):
    """The :class:`Node` of ``spec``: ``names``, ``theta0`` (lists) and
    ``fn(theta, d)``, the kernel's values at the distances ``d``."""
    (key, arg), = spec.items()
    if key == "sum":
        return _combine(build(arg[0]), build(arg[1]), lambda u, v: u + v)
    if key == "product":
        return _combine(build(arg[0]), build(arg[1]), lambda u, v: u * v)
    if key == "scale":
        c, inner = arg
        return build({"product": [{"Constant": {"value": c}}, inner]})
    mod = importlib.import_module("gpbench.reference.kernels." + key)
    return mod.node(arg, build)


def log(v):
    return math.log(float(v))
