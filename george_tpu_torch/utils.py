# -*- coding: utf-8 -*-
"""Small host-side utilities (the part of ``george_tpu/utils.py`` the
ported slice needs)."""

import numpy as np

__all__ = ["multivariate_gaussian_samples", "numerical_gradient"]


def multivariate_gaussian_samples(matrix, N, mean=None):
    """Samples from a multivariate Gaussian with covariance ``matrix``.

    Returns shape ``(k,)`` for ``N == 1`` else ``(N, k)``.
    """
    if mean is None:
        mean = np.zeros(len(matrix))
    samples = np.random.multivariate_normal(mean, matrix, N)
    if N == 1:
        return samples[0]
    return samples


def numerical_gradient(f, x, dx=1.234e-6):
    """Central finite-difference gradient of ``f`` at ``x`` (``x`` is
    nudged in place and restored)."""
    g = np.empty_like(x, dtype=float)
    for i in range(len(g)):
        x[i] += dx
        fp = f(x)
        x[i] -= 2 * dx
        fm = f(x)
        x[i] += dx
        g[i] = 0.5 * (fp - fm) / dx
    return g
