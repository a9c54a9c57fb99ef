# -*- coding: utf-8 -*-
"""Distance metrics for stationary kernels (PyTorch port of
``george_tpu/metrics.py``).

The host-side :class:`Metric` / :class:`Subspace` classes are the JAX
package's, unchanged. The functional side is written as *broadcast*
functions on tensors: ``r2(theta, x1, x2)`` takes point arrays of shape
``(..., d)`` that broadcast against each other and returns ``(...)``, so a
whole covariance block ``(m, d) x (n, d) -> (m, n)`` is one call on
``x1[:, None]`` and ``x2[None]`` rather than a map of a scalar pair
function.

Three metric types share one parameterization convention:

* ``metric_type == 0`` (isotropic): one parameter, the log of the squared
  length scale;  ``r2 = ||dx||^2 * exp(-theta)``.
* ``metric_type == 1`` (axis-aligned): one log-scale per selected axis;
  ``r2 = sum_j dx_j^2 * exp(-theta_j)``.
* ``metric_type == 2`` (general): a full SPD matrix ``M = L L^T`` through its
  log-Cholesky parameterization — packed row-major lower triangle, diagonal
  entries stored in log space;  ``r2 = || L^{-1} dx ||^2``.
"""

import numpy as np
import torch

from .modeling import Model

__all__ = ["Metric", "Subspace", "metric_param_count"]


class Subspace(object):
    """A selection of input axes a kernel operates on."""

    def __init__(self, ndim, axes=None):
        self.ndim = int(ndim)
        if axes is None:
            axes = np.arange(self.ndim)
        self.axes = np.atleast_1d(axes).astype(int)
        if np.any(self.axes >= self.ndim):
            raise ValueError(
                "invalid axis for {0} dimensional metric".format(self.ndim)
            )


class Metric(Model):
    """Squared-distance metric with named (log-space) parameters.

    Accepts a scalar (isotropic), a 1-D array (axis-aligned) or a 2-D SPD
    matrix (general).
    """

    def __init__(self, metric, bounds=None, ndim=None, axes=None, lower=True):
        if isinstance(metric, Metric):
            self.metric_type = metric.metric_type
            self.parameter_names = metric.parameter_names
            self.ndim = metric.ndim
            self.axes = metric.axes
            super(Metric, self).__init__(
                *metric.get_parameter_vector(include_frozen=True),
                bounds=metric.parameter_bounds
            )
            self.unfrozen_mask[:] = metric.unfrozen_mask
            return

        if ndim is None:
            raise ValueError("missing required parameter 'ndim'")

        subspace = Subspace(ndim, axes=axes)
        self.ndim = subspace.ndim
        self.axes = subspace.axes

        parameter_names = []
        parameters = []

        try:
            scalar = float(metric)
        except TypeError:
            metric = np.atleast_1d(metric)
            if metric.ndim == 1:
                # Axis-aligned: one squared length scale per axis.
                self.metric_type = 1
                if len(metric) != len(self.axes):
                    raise ValueError("dimension mismatch")
                if np.any(metric <= 0.0):
                    raise ValueError("invalid (negative) metric")
                for i, v in enumerate(metric):
                    parameter_names.append("log_M_{0}_{0}".format(i))
                    parameters.append(np.log(v))
            elif metric.ndim == 2:
                # General SPD matrix via log-Cholesky.
                self.metric_type = 2
                if metric.shape[0] != metric.shape[1]:
                    raise ValueError("metric must be square")
                if len(metric) != len(self.axes):
                    raise ValueError("dimension mismatch")
                L = np.linalg.cholesky(np.asarray(metric, dtype=np.float64))
                n = len(self.axes)
                for i in range(n):
                    parameter_names.append("log_L_{0}_{0}".format(i))
                    parameters.append(np.log(L[i, i]))
                    for j in range(i + 1, n):
                        parameter_names.append("L_{0}_{1}".format(i, j))
                        parameters.append(L[j, i])
            else:
                raise ValueError("invalid metric dimensions")
        else:
            self.metric_type = 0
            if scalar <= 0.0:
                raise ValueError("invalid (negative) metric")
            parameter_names.append("log_M_0_0")
            parameters.append(np.log(scalar))

        self.parameter_names = tuple(parameter_names)
        kwargs = {}
        if bounds is not None:
            kwargs["bounds"] = bounds
        super(Metric, self).__init__(*parameters, **kwargs)

    @property
    def full_size(self):
        return len(self.parameter_names)

    def to_matrix(self):
        """The metric as a dense SPD matrix over the selected axes."""
        vector = self.get_parameter_vector(include_frozen=True)
        n = len(self.axes)
        if self.metric_type == 0:
            return np.exp(vector[0]) * np.eye(n)
        if self.metric_type == 1:
            return np.diag(np.exp(vector))
        L = unpack_cholesky(torch.as_tensor(vector), n).numpy()
        return L @ L.T

    def __repr__(self):
        vector = self.get_parameter_vector(include_frozen=True)
        if self.metric_type == 0:
            params = ["{0}".format(float(np.exp(vector[0])))]
        elif self.metric_type == 1:
            params = ["{0}".format(repr(np.exp(vector)))]
        else:
            params = ["{0}".format(repr(self.to_matrix().tolist()))]
        params += [
            "ndim={0}".format(self.ndim),
            "axes={0}".format(repr(self.axes)),
        ]
        return "Metric({0})".format(", ".join(params))


# ---------------------------------------------------------------------------
# Functional (torch) side
# ---------------------------------------------------------------------------

def metric_param_count(metric_type, naxes):
    """Number of parameters of a metric of the given type over ``naxes``
    axes."""
    if metric_type == 0:
        return 1
    if metric_type == 1:
        return naxes
    if metric_type == 2:
        return naxes * (naxes + 1) // 2
    raise ValueError("unknown metric_type {0}".format(metric_type))


def _cholesky_layout(n):
    """Where each packed log-Cholesky parameter lands in the flattened
    ``(n, n)`` factor, and which parameters are log-space diagonals."""
    pos, is_diag = [], []
    for i in range(n):
        pos.append(i * n + i)
        is_diag.append(True)
        for j in range(i + 1, n):
            pos.append(j * n + i)
            is_diag.append(False)
    return pos, is_diag


def unpack_cholesky(theta, n):
    """Packed log-Cholesky parameters -> lower-triangular matrix ``L``.

    Parameter order ``log_L_00, L_01, ..., L_0n, log_L_11, ...``: entry
    ``L_{i}_{j}`` with ``i < j`` sits at row j, column i of L; diagonal
    entries are stored in log space. Built as a fixed 0/1 scatter matrix
    times the parameter vector — no in-place writes — so it composes with
    reverse mode, ``torch.func.jvp`` and ``vmap`` alike.
    """
    pos, is_diag = _cholesky_layout(n)
    mask = torch.tensor(is_diag, device=theta.device)
    vals = torch.where(mask, torch.exp(theta), theta)
    scatter = torch.zeros(n * n, len(pos), dtype=theta.dtype,
                          device=theta.device)
    scatter[pos, list(range(len(pos)))] = 1.0
    return (scatter @ vals).reshape(n, n)


def metric_r2_fn(metric_type, axes, ndim):
    """Build ``r2(theta, x1, x2)`` for the given metric structure.

    ``x1``/``x2`` are point arrays ``(..., ndim)`` that broadcast against
    each other; ``theta`` is the metric parameter vector. Returns the
    squared metric distance, shape ``(...)``.
    """
    axes = tuple(int(a) for a in axes)
    naxes = len(axes)
    full = axes == tuple(range(ndim))

    def _diff(x1, x2):
        d = x1 - x2
        return d if full else d[..., list(axes)]

    if metric_type == 0:

        def r2(theta, x1, x2):
            d = _diff(x1, x2)
            return torch.sum(d * d, dim=-1) * torch.exp(-theta[0])

    elif metric_type == 1:

        def r2(theta, x1, x2):
            d = _diff(x1, x2)
            return torch.sum(d * d * torch.exp(-theta), dim=-1)

    elif metric_type == 2:

        def r2(theta, x1, x2):
            d = _diff(x1, x2)
            L = unpack_cholesky(theta, naxes)
            flat = d.reshape(-1, naxes).T
            z = torch.linalg.solve_triangular(L, flat, upper=False)
            return torch.sum(z * z, dim=0).reshape(d.shape[:-1])

    else:
        raise ValueError("unknown metric_type {0}".format(metric_type))

    return r2
