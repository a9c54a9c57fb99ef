# -*- coding: utf-8 -*-
"""Solvers: exact (dense Cholesky), hierarchical (HODLR-class),
compact-support sparse (CG + SLQ, or the exact banded Cholesky on sorted
1-D data) and trivial (diagonal).

Protocol: ``compute(x, yerr, nns=None)``, ``apply_inverse(y)``,
``dot_solve(y)``, ``apply_forward(y, i)``, ``get_inverse()``,
``log_determinant``, ``computed``.
"""

from .trivial import TrivialSolver  # noqa: F401
from .basic import BasicSolver  # noqa: F401
from .hodlr import HODLRSolver  # noqa: F401
from .sparse import SparseSolver  # noqa: F401

__all__ = ["TrivialSolver", "BasicSolver", "HODLRSolver", "SparseSolver"]
