# -*- coding: utf-8 -*-
"""The kernel zoo: DSL-generated torch kernels plus composition operators.

Every spec-generated kernel of the JAX package (``kind: custom`` LCM and
WendlandC2 are not ported yet) with ``+`` / ``*`` algebra, three metric
types, axis subspaces and per-axis blocks.
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

__all__ = ["Kernel", "Sum", "Product"] + list(_generated_all)
