# -*- coding: utf-8 -*-
"""Exact dense solver (PyTorch port of ``george_tpu/solvers/basic.py``):
assemble ``K + diag`` with the kernel's block function and factor it with
``torch.linalg.cholesky``, on the solver's device and dtype."""

import numpy as np
import torch

from .linalg import as_points, cholesky_factor, chol_solve

__all__ = ["BasicSolver"]


class BasicSolver(object):
    """Dense exact solver with a Cholesky factorization of ``K + diag``.

    :param kernel: the covariance kernel.
    :param device: torch device the factorization lives on (default
        ``"cuda"``; pass ``"cpu"`` explicitly on a host without a card).
    :param dtype: working dtype (default ``torch.float64``).
    """

    def __init__(self, kernel, device="cuda", dtype=torch.float64,
                 **kwargs):
        self.kernel = kernel
        self.device = torch.device(device)
        self.dtype = dtype
        self.computed = False
        self.log_determinant = None
        self._L = None
        self._x = None
        self._yerr2 = None

    def _tensor(self, a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64)).to(
            device=self.device, dtype=self.dtype
        )

    def _theta(self):
        return self._tensor(self.kernel.parameter_vector)

    def compute(self, x, yerr=0.0, nns=None, **kwargs):
        """Assemble and factorize ``K(x, x) + diag(yerr^2)``."""
        x = as_points(x)
        yerr2 = np.atleast_1d(np.asarray(yerr, dtype=np.float64)) ** 2
        if yerr2.size == 1:
            yerr2 = yerr2 * np.ones(len(x))
        self._x = self._tensor(x)
        self._yerr2 = self._tensor(yerr2)
        with torch.no_grad():
            K = self.kernel.gram(self._theta(), self._x, self._x)
            L = cholesky_factor(K, self._yerr2)
        self._L = L
        self.log_determinant = float(2.0 * torch.sum(torch.log(
            torch.diagonal(L))))
        self.computed = True

    def apply_inverse(self, y, in_place=False):
        """``(K + diag)^{-1} y`` for a vector or matrix of RHS."""
        return chol_solve(self._L, self._tensor(y)).cpu().numpy().astype(
            np.float64)

    def dot_solve(self, y):
        """``y^T (K + diag)^{-1} y``."""
        y = self._tensor(y)
        return float(torch.dot(y, chol_solve(self._L, y)))

    def apply_forward(self, y, i=0):
        """Matvec with ``K + diag`` (``i == 0``) or with
        ``dK/dtheta_{i-1}`` (a forward-mode derivative of the block)."""
        y = self._tensor(y)
        theta = self._theta()
        if i == 0:
            K = self.kernel.gram(theta, self._x, self._x)
            K = K + torch.diag(self._yerr2)
        else:
            tangent = torch.zeros_like(theta)
            tangent[i - 1] = 1.0
            _, K = torch.func.jvp(
                lambda th: self.kernel.gram(th, self._x, self._x),
                (theta,), (tangent,),
            )
        return (K @ y).detach().cpu().numpy()

    def get_inverse(self):
        n = self._L.shape[0]
        eye = torch.eye(n, dtype=self.dtype, device=self.device)
        return chol_solve(self._L, eye).cpu().numpy()
