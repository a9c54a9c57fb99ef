# -*- coding: utf-8 -*-
"""Functional linear-algebra core shared by the solvers (PyTorch port of
``george_tpu/solvers/linalg.py``).

Pure functions on tensors; the stateful solver classes hold factorization
state between the george-style ``compute`` / ``apply_inverse`` /
``log_determinant`` calls, and everything here composes with autograd for
the fused likelihood path. A 2-D dense Cholesky stays
``torch.linalg.cholesky``, as the JAX package left it to XLA: the
hand-written kernel serves the hierarchical solver's batched leaf boxes.
"""

import math

import numpy as np
import torch

__all__ = [
    "as_points",
    "assemble_dense",
    "cholesky_factor",
    "chol_solve",
    "chol_logdet",
    "chol_dot_solve",
    "mahalanobis_loglike",
]


def as_points(x):
    """Normalize solver inputs to an ``(n, d)`` float64 coordinate array.

    A 1-D ``x`` means n scalar points — NOT one n-dimensional point, which
    is what ``np.atleast_2d``'s ``(1, n)`` row would silently make it.
    """
    x = np.ascontiguousarray(np.asarray(x, dtype=np.float64))
    if x.ndim == 1:
        x = x[:, None]
    if x.ndim != 2:
        raise ValueError(
            "Dimension mismatch: x must be (n,) or (n, d), got shape %s"
            % (x.shape,)
        )
    return x


def assemble_dense(pair_fn, theta, x1, x2):
    """Dense covariance matrix ``K[i, j] = pair_fn(theta, x1[i], x2[j])``
    of point arrays ``(n1, d)`` and ``(n2, d)``, by one broadcast call of
    the pair function."""
    return pair_fn(theta, x1[:, None, :], x2[None, :, :])


def cholesky_factor(K, diag=None):
    """Lower Cholesky factor of ``K + diag`` (``diag`` is a vector); raises
    ``LinAlgError`` when the matrix is not positive definite."""
    if diag is not None:
        K = K + torch.diag(diag)
    L, info = torch.linalg.cholesky_ex(K)
    if int(info) != 0 or not bool(torch.isfinite(torch.diagonal(L)).all()):
        raise np.linalg.LinAlgError(
            "covariance matrix is not positive definite"
        )
    return L


def chol_solve(L, y):
    """Solve ``(L L^T) x = y`` for one or many right-hand sides."""
    squeeze = y.ndim == 1
    if squeeze:
        y = y[:, None]
    x = torch.cholesky_solve(y, L, upper=False)
    return x[:, 0] if squeeze else x


def chol_logdet(L):
    """``log |L L^T|`` from the factor diagonal."""
    return 2.0 * torch.sum(torch.log(torch.diagonal(L)))


def chol_dot_solve(L, y):
    """``y^T (L L^T)^{-1} y`` without forming the inverse."""
    z = torch.linalg.solve_triangular(L, y[:, None], upper=False)
    return torch.sum(z * z)


def mahalanobis_loglike(L, r):
    """Gaussian log-density from a Cholesky factor and residual."""
    n = r.shape[0]
    return -0.5 * (
        chol_dot_solve(L, r) + chol_logdet(L) + n * math.log(2.0 * math.pi)
    )


def _per_member(apply, info, in_dims, args):
    """A Function's ``vmap`` rule that runs the batch members one after
    another: ``apply`` on each member's slice of the batched arguments,
    the results (a tensor, or each tensor of a tuple) stacked along
    dimension 0."""
    outs = [apply(*[a if d is None else a.select(d, i)
                    for a, d in zip(args, in_dims)])
            for i in range(info.batch_size)]
    if isinstance(outs[0], tuple):
        return (tuple(torch.stack(o) for o in zip(*outs)),
                (0,) * len(outs[0]))
    return torch.stack(outs), 0
