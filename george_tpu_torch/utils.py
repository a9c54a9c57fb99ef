# -*- coding: utf-8 -*-
"""Small host-side utilities (the part of ``george_tpu/utils.py`` the
ported slice needs)."""

import numpy as np

from .neighbors import nd_sort_samples  # noqa: F401  (re-export)

__all__ = ["multivariate_gaussian_samples", "nd_sort_samples",
           "numerical_gradient", "check_gradient"]


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


def check_gradient(obj, *args, **kwargs):
    """Check a model's ``get_gradient`` against centred differences of its
    ``get_value`` in each parameter (step ``eps``, default 1.23e-5); the
    other arguments go to both methods. Raises ``AssertionError`` naming
    the first parameter that disagrees."""
    eps = kwargs.pop("eps", 1.23e-5)

    grad0 = obj.get_gradient(*args, **kwargs)
    vector = obj.get_parameter_vector()
    for i, v in enumerate(vector):
        vector[i] = v + eps
        obj.set_parameter_vector(vector)
        p = obj.get_value(*args, **kwargs)

        vector[i] = v - eps
        obj.set_parameter_vector(vector)
        m = obj.get_value(*args, **kwargs)

        vector[i] = v
        obj.set_parameter_vector(vector)

        grad = 0.5 * (p - m) / eps
        assert np.allclose(grad0[i], grad), (
            "grad computation failed for '{0}' ({1})".format(
                obj.get_parameter_names()[i], i
            )
        )
