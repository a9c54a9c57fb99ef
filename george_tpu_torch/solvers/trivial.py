# -*- coding: utf-8 -*-
"""Diagonal-only solver for kernel-free GPs (port of
``george_tpu/solvers/trivial.py``; numpy only)."""

import numpy as np

__all__ = ["TrivialSolver"]


class TrivialSolver(object):
    """Solver for ``K = diag(yerr^2)`` (no kernel, or :class:`EmptyKernel`)."""

    def __init__(self, kernel=None, **kwargs):
        self.kernel = kernel
        self.computed = False
        self.log_determinant = None
        self._ivar = None

    def compute(self, x, yerr=0.0, nns=None, **kwargs):
        yerr2 = np.atleast_1d(np.asarray(yerr, dtype=np.float64)) ** 2
        if yerr2.size == 1:
            yerr2 = yerr2 * np.ones(len(x))
        self.log_determinant = float(np.sum(np.log(yerr2)))
        self._ivar = 1.0 / yerr2
        self.computed = True

    def apply_inverse(self, y, in_place=False):
        y = np.atleast_1d(np.asarray(y, dtype=np.float64))
        if y.ndim == 1:
            return y * self._ivar
        return y * self._ivar[:, None]

    def dot_solve(self, y):
        y = np.asarray(y, dtype=np.float64)
        return float(np.sum(y * y * self._ivar))

    def apply_forward(self, y, i=0):
        if i != 0:
            raise ValueError("TrivialSolver has no kernel gradients")
        y = np.asarray(y, dtype=np.float64)
        if y.ndim == 1:
            return y / self._ivar
        return y / self._ivar[:, None]

    def get_inverse(self):
        return np.diag(self._ivar)
