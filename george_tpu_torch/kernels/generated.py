# -*- coding: utf-8 -*-
"""AUTO-GENERATED by ``python -m george_tpu_torch.kernels.codegen`` — do not
edit.

Kernel classes compiled from the YAML specs in
``george_tpu_torch/kernels/specs/`` (torch target).
"""

import torch

from ..modeling import Model
from ..metrics import Metric, Subspace
from .base import (
    StationaryKernel,
    NonStationaryKernel,
    safe_sqrt,
    M_PI,
)


__all__ = [
    "LinearKernel",
    "BaseLinearKernel",
    "RationalQuadraticKernel",
    "BaseRationalQuadraticKernel",
    "ExpKernel",
    "BaseExpKernel",
    "LocalGaussianKernel",
    "BaseLocalGaussianKernel",
    "EmptyKernel",
    "BaseEmptyKernel",
    "CosineKernel",
    "BaseCosineKernel",
    "Matern52Kernel",
    "BaseMatern52Kernel",
    "ExpSine2Kernel",
    "BaseExpSine2Kernel",
    "ConstantKernel",
    "BaseConstantKernel",
    "ExpSquaredKernel",
    "BaseExpSquaredKernel",
    "Matern32Kernel",
    "BaseMatern32Kernel",
    "PolynomialKernel",
    "BasePolynomialKernel",
    "DotProductKernel",
    "BaseDotProductKernel",
]


def _value_linear(x1, x2, log_gamma2, order):
    inv_gamma2 = torch.exp(-log_gamma2)
    if order == 0.0:
        return inv_gamma2 + 0.0 * (x1 - x2)
    return (x1 * x2) ** order * inv_gamma2


class _BaseLinearKernel(Model):
    parameter_names = ("log_gamma2", )


BaseLinearKernel = _BaseLinearKernel


class LinearKernel(NonStationaryKernel):
    r"""
    The linear regression kernel:
    :math:`k(x_i, x_j) = (x_i \cdot x_j)^P / \gamma^2`.

    :param order: the (constant, non-fitted) power :math:`P`.
    :param log_gamma2: the log of the scale factor :math:`\gamma^2`.
    """

    kernel_type = 0
    _base_param_names = ("log_gamma2", )
    _constant_names = ("order", )
    _value_fn = staticmethod(_value_linear)

    def __init__(self, log_gamma2=None, order=None,
                 bounds=None, ndim=1, axes=None):
        if order is None:
            raise ValueError("missing required parameter 'order'")
        self.order = float(order)
        subspace = Subspace(ndim, axes=axes)
        kwargs = dict(log_gamma2=log_gamma2)
        if bounds is not None:
            kwargs["bounds"] = bounds
        base = _BaseLinearKernel(**kwargs)
        self._init_nonstationary(base, subspace)


def _value_rationalquadratic(r2, log_alpha):
    alpha = torch.exp(log_alpha)
    return (1.0 + 0.5 * r2 / alpha) ** (-alpha)


class _BaseRationalQuadraticKernel(Model):
    parameter_names = ("log_alpha", )


BaseRationalQuadraticKernel = _BaseRationalQuadraticKernel


class RationalQuadraticKernel(StationaryKernel):
    r"""
    A scale mixture of ExpSquared kernels with gamma-distributed inverse
    squared length scales: :math:`k(r^2) = [1 + r^2/(2\alpha)]^{-\alpha}`.

    :param log_alpha: the log of the gamma distribution parameter.
    """

    kernel_type = 1
    _base_param_names = ("log_alpha", )
    _constant_names = ()
    _value_fn = staticmethod(_value_rationalquadratic)

    def __init__(self, log_alpha=None,
                 metric=None, metric_bounds=None, lower=True, block=None,
                 bounds=None, ndim=1, axes=None):
        if metric is None:
            raise ValueError("missing required parameter 'metric'")
        metric = Metric(metric, bounds=metric_bounds, ndim=ndim,
                        axes=axes, lower=lower)
        kwargs = dict(log_alpha=log_alpha)
        if bounds is not None:
            kwargs["bounds"] = bounds
        base = _BaseRationalQuadraticKernel(**kwargs)
        self._init_stationary(base, metric, block)


def _value_exp(r2):
    return torch.exp(-safe_sqrt(r2))


class _BaseExpKernel(Model):
    parameter_names = ()


BaseExpKernel = _BaseExpKernel


class ExpKernel(StationaryKernel):
    r"""
    The exponential kernel: :math:`k(r^2) = \exp(-\sqrt{r^2})`.
    """

    kernel_type = 2
    _base_param_names = ()
    _constant_names = ()
    _value_fn = staticmethod(_value_exp)

    def __init__(self,
                 metric=None, metric_bounds=None, lower=True, block=None,
                 bounds=None, ndim=1, axes=None):
        if metric is None:
            raise ValueError("missing required parameter 'metric'")
        metric = Metric(metric, bounds=metric_bounds, ndim=ndim,
                        axes=axes, lower=lower)
        kwargs = dict()
        if bounds is not None:
            kwargs["bounds"] = bounds
        base = _BaseExpKernel(**kwargs)
        self._init_stationary(base, metric, block)


def _value_localgaussian(x1, x2, location, log_width):
    inv_2w = 0.5 * torch.exp(-log_width)
    d1 = x1 - location
    d2 = x2 - location
    return torch.exp(-(d1 * d1 + d2 * d2) * inv_2w)


class _BaseLocalGaussianKernel(Model):
    parameter_names = ("location", "log_width", )


BaseLocalGaussianKernel = _BaseLocalGaussianKernel


class LocalGaussianKernel(NonStationaryKernel):
    r"""
    A local Gaussian kernel:
    :math:`k(x_i, x_j) = \exp(-[(x_i - x_0)^2 + (x_j - x_0)^2] / (2 w))`.

    :param location: the location :math:`x_0` of the Gaussian.
    :param log_width: the log of the (squared) width :math:`w`.
    """

    kernel_type = 3
    _base_param_names = ("location", "log_width", )
    _constant_names = ()
    _value_fn = staticmethod(_value_localgaussian)

    def __init__(self, location=None, log_width=None,
                 bounds=None, ndim=1, axes=None):
        subspace = Subspace(ndim, axes=axes)
        kwargs = dict(location=location, log_width=log_width)
        if bounds is not None:
            kwargs["bounds"] = bounds
        base = _BaseLocalGaussianKernel(**kwargs)
        self._init_nonstationary(base, subspace)


def _value_empty(x1, x2):
    return 0.0 * (x1 - x2)


class _BaseEmptyKernel(Model):
    parameter_names = ()


BaseEmptyKernel = _BaseEmptyKernel


class EmptyKernel(NonStationaryKernel):
    r"""
    A no-op kernel that evaluates to zero everywhere; a GP constructed with it
    (or no kernel) uses the TrivialSolver.
    """

    kernel_type = 4
    _base_param_names = ()
    _constant_names = ()
    _value_fn = staticmethod(_value_empty)

    def __init__(self,
                 bounds=None, ndim=1, axes=None):
        subspace = Subspace(ndim, axes=axes)
        kwargs = dict()
        if bounds is not None:
            kwargs["bounds"] = bounds
        base = _BaseEmptyKernel(**kwargs)
        self._init_nonstationary(base, subspace)


def _value_cosine(x1, x2, log_period):
    factor = 2.0 * M_PI * torch.exp(-log_period)
    return torch.cos((x1 - x2) * factor)


class _BaseCosineKernel(Model):
    parameter_names = ("log_period", )


BaseCosineKernel = _BaseCosineKernel


class CosineKernel(NonStationaryKernel):
    r"""
    The simplest periodic kernel:
    :math:`k(x_i, x_j) = \cos(2\pi |x_i - x_j| / P)`.

    :param log_period: the log of the period of the oscillation.
    """

    kernel_type = 5
    _base_param_names = ("log_period", )
    _constant_names = ()
    _value_fn = staticmethod(_value_cosine)

    def __init__(self, log_period=None,
                 bounds=None, ndim=1, axes=None):
        subspace = Subspace(ndim, axes=axes)
        kwargs = dict(log_period=log_period)
        if bounds is not None:
            kwargs["bounds"] = bounds
        base = _BaseCosineKernel(**kwargs)
        self._init_nonstationary(base, subspace)


def _value_matern52(r2):
    r = safe_sqrt(5.0 * r2)
    return (1.0 + r + 5.0 * r2 / 3.0) * torch.exp(-r)


class _BaseMatern52Kernel(Model):
    parameter_names = ()


BaseMatern52Kernel = _BaseMatern52Kernel


class Matern52Kernel(StationaryKernel):
    r"""
    The Matern-5/2 kernel:
    :math:`k(r^2) = (1 + \sqrt{5 r^2} + 5 r^2 / 3) \exp(-\sqrt{5 r^2})`.
    """

    kernel_type = 6
    _base_param_names = ()
    _constant_names = ()
    _value_fn = staticmethod(_value_matern52)

    def __init__(self,
                 metric=None, metric_bounds=None, lower=True, block=None,
                 bounds=None, ndim=1, axes=None):
        if metric is None:
            raise ValueError("missing required parameter 'metric'")
        metric = Metric(metric, bounds=metric_bounds, ndim=ndim,
                        axes=axes, lower=lower)
        kwargs = dict()
        if bounds is not None:
            kwargs["bounds"] = bounds
        base = _BaseMatern52Kernel(**kwargs)
        self._init_stationary(base, metric, block)


def _value_expsine2(x1, x2, gamma, log_period):
    factor = M_PI * torch.exp(-log_period)
    s = torch.sin((x1 - x2) * factor)
    return torch.exp(-gamma * s * s)


class _BaseExpSine2Kernel(Model):
    parameter_names = ("gamma", "log_period", )


BaseExpSine2Kernel = _BaseExpSine2Kernel


class ExpSine2Kernel(NonStationaryKernel):
    r"""
    The exp-sine-squared periodic kernel:
    :math:`k(x_i, x_j) = \exp(-\Gamma \sin^2[\pi |x_i - x_j| / P])`.

    :param gamma: the scale :math:`\Gamma` of the correlations.
    :param log_period: the log of the period :math:`P` of the oscillation.
    """

    kernel_type = 7
    _base_param_names = ("gamma", "log_period", )
    _constant_names = ()
    _value_fn = staticmethod(_value_expsine2)

    def __init__(self, gamma=None, log_period=None,
                 bounds=None, ndim=1, axes=None):
        subspace = Subspace(ndim, axes=axes)
        kwargs = dict(gamma=gamma, log_period=log_period)
        if bounds is not None:
            kwargs["bounds"] = bounds
        base = _BaseExpSine2Kernel(**kwargs)
        self._init_nonstationary(base, subspace)


def _value_constant(x1, x2, log_constant):
    constant = torch.exp(log_constant)
    return constant + 0.0 * (x1 - x2)


class _BaseConstantKernel(Model):
    parameter_names = ("log_constant", )


BaseConstantKernel = _BaseConstantKernel


class ConstantKernel(NonStationaryKernel):
    r"""
    A constant kernel :math:`k(x_i, x_j) = c` per selected axis (summed over
    axes). This is the lifting target for ``scalar * kernel`` and
    ``scalar + kernel`` expressions.

    :param log_constant: the log of the per-axis constant.
    """

    kernel_type = 8
    _base_param_names = ("log_constant", )
    _constant_names = ()
    _value_fn = staticmethod(_value_constant)

    def __init__(self, log_constant=None,
                 bounds=None, ndim=1, axes=None):
        subspace = Subspace(ndim, axes=axes)
        kwargs = dict(log_constant=log_constant)
        if bounds is not None:
            kwargs["bounds"] = bounds
        base = _BaseConstantKernel(**kwargs)
        self._init_nonstationary(base, subspace)


def _value_expsquared(r2):
    return torch.exp(-0.5 * r2)


class _BaseExpSquaredKernel(Model):
    parameter_names = ()


BaseExpSquaredKernel = _BaseExpSquaredKernel


class ExpSquaredKernel(StationaryKernel):
    r"""
    The exponential-squared kernel is a stationary kernel where the value
    at a given squared radius :math:`r^2` is
    :math:`k(r^2) = \exp(-r^2 / 2)`.
    """

    kernel_type = 9
    _base_param_names = ()
    _constant_names = ()
    _value_fn = staticmethod(_value_expsquared)

    def __init__(self,
                 metric=None, metric_bounds=None, lower=True, block=None,
                 bounds=None, ndim=1, axes=None):
        if metric is None:
            raise ValueError("missing required parameter 'metric'")
        metric = Metric(metric, bounds=metric_bounds, ndim=ndim,
                        axes=axes, lower=lower)
        kwargs = dict()
        if bounds is not None:
            kwargs["bounds"] = bounds
        base = _BaseExpSquaredKernel(**kwargs)
        self._init_stationary(base, metric, block)


def _value_matern32(r2):
    r = safe_sqrt(3.0 * r2)
    return (1.0 + r) * torch.exp(-r)


class _BaseMatern32Kernel(Model):
    parameter_names = ()


BaseMatern32Kernel = _BaseMatern32Kernel


class Matern32Kernel(StationaryKernel):
    r"""
    The Matern-3/2 kernel:
    :math:`k(r^2) = (1 + \sqrt{3 r^2}) \exp(-\sqrt{3 r^2})`.
    """

    kernel_type = 10
    _base_param_names = ()
    _constant_names = ()
    _value_fn = staticmethod(_value_matern32)

    def __init__(self,
                 metric=None, metric_bounds=None, lower=True, block=None,
                 bounds=None, ndim=1, axes=None):
        if metric is None:
            raise ValueError("missing required parameter 'metric'")
        metric = Metric(metric, bounds=metric_bounds, ndim=ndim,
                        axes=axes, lower=lower)
        kwargs = dict()
        if bounds is not None:
            kwargs["bounds"] = bounds
        base = _BaseMatern32Kernel(**kwargs)
        self._init_stationary(base, metric, block)


def _value_polynomial(x1, x2, log_sigma2, order):
    sigma2 = torch.exp(log_sigma2)
    if order == 0.0:
        return 1.0 + 0.0 * (x1 - x2)
    return (x1 * x2 + sigma2) ** order


class _BasePolynomialKernel(Model):
    parameter_names = ("log_sigma2", )


BasePolynomialKernel = _BasePolynomialKernel


class PolynomialKernel(NonStationaryKernel):
    r"""
    A polynomial kernel:
    :math:`k(x_i, x_j) = (x_i \cdot x_j + \sigma^2)^P`.

    :param order: the (constant, non-fitted) power :math:`P`.
    :param log_sigma2: the log of the variance :math:`\sigma^2`.
    """

    kernel_type = 11
    _base_param_names = ("log_sigma2", )
    _constant_names = ("order", )
    _value_fn = staticmethod(_value_polynomial)

    def __init__(self, log_sigma2=None, order=None,
                 bounds=None, ndim=1, axes=None):
        if order is None:
            raise ValueError("missing required parameter 'order'")
        self.order = float(order)
        subspace = Subspace(ndim, axes=axes)
        kwargs = dict(log_sigma2=log_sigma2)
        if bounds is not None:
            kwargs["bounds"] = bounds
        base = _BasePolynomialKernel(**kwargs)
        self._init_nonstationary(base, subspace)


def _value_dotproduct(x1, x2):
    return x1 * x2


class _BaseDotProductKernel(Model):
    parameter_names = ()


BaseDotProductKernel = _BaseDotProductKernel


class DotProductKernel(NonStationaryKernel):
    r"""
    The dot-product kernel :math:`k(x_i, x_j) = x_i \cdot x_j`, with no
    parameters.
    """

    kernel_type = 12
    _base_param_names = ()
    _constant_names = ()
    _value_fn = staticmethod(_value_dotproduct)

    def __init__(self,
                 bounds=None, ndim=1, axes=None):
        subspace = Subspace(ndim, axes=axes)
        kwargs = dict()
        if bounds is not None:
            kwargs["bounds"] = bounds
        base = _BaseDotProductKernel(**kwargs)
        self._init_nonstationary(base, subspace)

