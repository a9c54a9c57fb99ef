# -*- coding: utf-8 -*-
"""The kernel zoo: DSL-generated torch kernels plus composition operators.

Every spec-generated kernel of the JAX package with ``+`` / ``*`` algebra,
three metric types, axis subspaces and per-axis blocks, and the hand-written
compact-support ``WendlandC2Kernel`` (``custom.py``). The ``kind: custom``
LCM kernel is not ported yet.
"""

from .base import (  # noqa: F401
    Kernel,
    Sum,
    Product,
    StationaryKernel,
    NonStationaryKernel,
    safe_sqrt,
)
from .generated import *  # noqa: F401,F403  (XKernel + BaseXKernel pairs)
from .generated import __all__ as _generated_all
from .custom import WendlandC2Kernel, BaseWendlandC2Kernel  # noqa: F401

__all__ = ["Kernel", "Sum", "Product", "WendlandC2Kernel",
           "BaseWendlandC2Kernel"] + list(_generated_all)
