# -*- coding: utf-8 -*-
"""The user-facing GP object (PyTorch port of ``george_tpu/gp.py``).

* The covariance is the kernel's broadcast block function
  (``kernels/base.py``), evaluated on the GP's ``device`` in its ``dtype``.
* Solvers factorize on that device; the solver is built from
  ``solver=`` with the same ``device`` and ``dtype``.
* ``grad_log_likelihood`` is autograd of the whole marginal likelihood
  through the solver's differentiable factorization (``loglike_fn``) or,
  for a solver without one, through a dense Cholesky; matrix-free solvers
  (HODLR with ``grad_mode="hutchinson"``) supply a Hutchinson-estimated
  gradient instead.

``compute(x, yerr)`` takes the vanilla george argument order; neighbor
structures are the optional keyword ``nns``.
"""

import numpy as np
import torch

from . import kernels
from .modeling import ModelSet, ConstantModel, Model, CallableModel
from .neighbors import normalize_nns
from .solvers import TrivialSolver, BasicSolver
from .solvers.linalg import mahalanobis_loglike

__all__ = ["GP", "TINY"]

# Tiny diagonal jitter (as the default white-noise level) keeping K positive
# definite in the absence of observational uncertainties.
TINY = 1.25e-12

# what a failed factorization or likelihood raises, by source
_FAILURES = (ValueError, np.linalg.LinAlgError, torch.linalg.LinAlgError)


def _parse_model(model):
    try:
        val = float(model)
    except TypeError:
        if callable(model) and not isinstance(model, Model):
            return CallableModel(model)
        return model
    return ConstantModel(val)


class GP(ModelSet):
    """A Gaussian process with a mean model, white-noise model and kernel.

    :param kernel: a :class:`kernels.Kernel`; ``None`` means an
        :class:`EmptyKernel` served by the :class:`TrivialSolver`.
    :param fit_kernel: include kernel parameters in the fitted vector.
    :param mean: scalar, callable, or modeling-protocol object for the mean.
    :param fit_mean: include mean parameters in the fitted vector.
    :param white_noise: scalar, callable, or model for the *log* white-noise
        variance added to the diagonal.
    :param fit_white_noise: include white-noise parameters in the fit.
    :param solver: solver class (default: :class:`BasicSolver`, or
        :class:`TrivialSolver` when there is no kernel).
    :param device: torch device of the factorization and the fused
        likelihood (default ``"cuda"``, the card). It is never chosen
        automatically: on a host without CUDA, pass ``device="cpu"`` or
        torch raises at the first tensor.
    :param dtype: working dtype (default ``torch.float64``).
    :param kwargs: forwarded to the solver constructor.
    """

    def __init__(
        self,
        kernel=None,
        fit_kernel=True,
        mean=None,
        fit_mean=None,
        white_noise=None,
        fit_white_noise=None,
        solver=None,
        device="cuda",
        dtype=torch.float64,
        **kwargs
    ):
        self._computed = False
        self._alpha = None
        self._y = None
        self.device = torch.device(device)
        self.dtype = dtype

        super(GP, self).__init__(
            [
                (
                    "mean",
                    ConstantModel(0.0) if mean is None else _parse_model(mean),
                ),
                (
                    "white_noise",
                    ConstantModel(np.log(TINY))
                    if white_noise is None
                    else _parse_model(white_noise),
                ),
                (
                    "kernel",
                    kernels.EmptyKernel() if kernel is None else kernel,
                ),
            ]
        )

        # Constants default to not-fitted.
        try:
            float(mean)
        except TypeError:
            pass
        else:
            fit_mean = False if fit_mean is None else fit_mean
        try:
            float(white_noise)
        except TypeError:
            pass
        else:
            fit_white_noise = (
                False if fit_white_noise is None else fit_white_noise
            )

        if not fit_kernel:
            self.models["kernel"].freeze_all_parameters()
        if mean is None or (fit_mean is not None and not fit_mean):
            self.models["mean"].freeze_all_parameters()
        if white_noise is None or (
            fit_white_noise is not None and not fit_white_noise
        ):
            self.models["white_noise"].freeze_all_parameters()

        if solver is None:
            trivial = (
                kernel is None
                or kernel.kernel_type == kernels.EmptyKernel.kernel_type
            )
            solver = TrivialSolver if trivial else BasicSolver
        self.solver_type = solver
        self.solver_kwargs = kwargs
        self.solver = None

    # ------------------------------------------------------------------
    # Sub-model access
    # ------------------------------------------------------------------

    @property
    def mean(self):
        return self.models["mean"]

    @property
    def white_noise(self):
        return self.models["white_noise"]

    @property
    def kernel(self):
        return self.models["kernel"]

    def _call_mean(self, x):
        if x.ndim == 2 and x.shape[1] == 1:
            mu = np.asarray(self.mean.get_value(x[:, 0])).flatten()
        else:
            mu = np.asarray(self.mean.get_value(x)).flatten()
        if not np.all(np.isfinite(mu)):
            raise ValueError("mean function returned NaN or Inf")
        return mu

    def _call_mean_gradient(self, x):
        if x.ndim == 2 and x.shape[1] == 1:
            mu = self.mean.get_gradient(x[:, 0])
        else:
            mu = self.mean.get_gradient(x)
        if np.any(~np.isfinite(mu)):
            raise ValueError("mean gradient returned NaN or Inf")
        return mu

    def _call_white_noise(self, x):
        if x.ndim == 2 and x.shape[1] == 1:
            return np.asarray(self.white_noise.get_value(x[:, 0])).flatten()
        return np.asarray(self.white_noise.get_value(x)).flatten()

    def _call_white_noise_gradient(self, x):
        if x.ndim == 2 and x.shape[1] == 1:
            return self.white_noise.get_gradient(x[:, 0])
        return self.white_noise.get_gradient(x)

    def _tensor(self, a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64)).to(
            device=self.device, dtype=self.dtype
        )

    # ------------------------------------------------------------------
    # Computation state
    # ------------------------------------------------------------------

    @property
    def computed(self):
        return (
            self._computed
            and self.solver is not None
            and self.solver.computed
            and not self.kernel.dirty
        )

    @computed.setter
    def computed(self, v):
        self._computed = v
        if v:
            self.kernel.dirty = False

    def parse_samples(self, t):
        """Coerce input coordinates to ``(n, ndim)`` float64."""
        t = np.atleast_1d(np.asarray(t, dtype=np.float64))
        if t.ndim == 1:
            t = t[:, None]
        if t.ndim != 2 or t.shape[1] != self.kernel.input_ndim:
            raise ValueError("Dimension mismatch")
        return np.ascontiguousarray(t, dtype=np.float64)

    def _check_dimensions(self, y, check_dim=True):
        n, _ = self._x.shape
        y = np.atleast_1d(y)
        if check_dim and y.ndim > 1:
            raise ValueError("The predicted dimension must be 1-D")
        if len(y) != n:
            raise ValueError("Dimension mismatch")
        return y

    def compute(self, x, yerr=0.0, nns=None, **kwargs):
        """Assemble and factorize ``K(x, x) + diag(yerr^2 + exp(wn))``."""
        self._x = self.parse_samples(x)
        self._nns = normalize_nns(nns)
        try:
            self._yerr2 = float(yerr) ** 2 * np.ones(len(x))
        except TypeError:
            self._yerr2 = self._check_dimensions(yerr) ** 2
        self._yerr2 = np.ascontiguousarray(self._yerr2, dtype=np.float64)

        self.solver = self.solver_type(
            self.kernel, device=self.device, dtype=self.dtype,
            **self.solver_kwargs
        )
        yerr_eff = np.sqrt(
            self._yerr2 + np.exp(self._call_white_noise(self._x))
        )
        self.solver.compute(self._x, yerr_eff, nns=self._nns, **kwargs)

        self._const = -0.5 * (
            len(self._x) * np.log(2 * np.pi) + self.solver.log_determinant
        )
        self.computed = True
        self._alpha = None

    def recompute(self, quiet=False, **kwargs):
        """Refactorize iff the parameters changed since :func:`compute`."""
        if not self.computed:
            if not (hasattr(self, "_x") and hasattr(self, "_yerr2")):
                raise RuntimeError("You need to compute the model first")
            try:
                self.compute(
                    self._x, np.sqrt(self._yerr2), nns=self._nns, **kwargs
                )
            except _FAILURES:
                if quiet:
                    return False
                raise
        return True

    # ------------------------------------------------------------------
    # Likelihood
    # ------------------------------------------------------------------

    def log_likelihood(self, y, quiet=False):
        """Marginal log-likelihood of ``y`` under the GP (requires
        :func:`compute`)."""
        if not self.recompute(quiet=quiet):
            return -np.inf
        try:
            mu = self._call_mean(self._x)
        except ValueError:
            if quiet:
                return -np.inf
            raise
        r = np.ascontiguousarray(
            self._check_dimensions(y) - mu, dtype=np.float64
        )
        ll = self._const - 0.5 * self.solver.dot_solve(r)
        return ll if np.isfinite(ll) else -np.inf

    def grad_log_likelihood(self, y, quiet=False):
        """Gradient of :func:`log_likelihood` w.r.t. the active parameters.

        Exact solvers: one reverse-mode sweep through the fused
        (assemble -> factor -> solve -> logdet) computation. Matrix-free
        solvers: the solver's Hutchinson-estimated gradient.
        """
        if not self.recompute(quiet=quiet):
            return np.zeros(len(self), dtype=np.float64)

        if getattr(self.solver, "matrix_free", False):
            return self._grad_log_likelihood_matrix_free(y, quiet=quiet)

        if not self._traceable:
            return self._grad_log_likelihood_host(y, quiet=quiet)
        try:
            theta = self._tensor(self.parameter_vector).requires_grad_(True)
            ll = self._fused_loglike_full()(
                theta,
                self._tensor(self._x),
                self._tensor(self._check_dimensions(y)),
                self._tensor(self._yerr2),
            )
            (g,) = torch.autograd.grad(ll, theta)
            g = g.detach().cpu().numpy().astype(np.float64)
            g = g[self.unfrozen_mask]
            if not np.all(np.isfinite(g)):
                raise ValueError("non-finite gradient")
            return g
        except _FAILURES:
            if quiet:
                return np.zeros(len(self), dtype=np.float64)
            raise

    @property
    def _traceable(self):
        return self.mean.traceable and self.white_noise.traceable

    def _fused_loglike_full(self):
        """Pure ``loglike(theta_full, x, y, yerr2)`` on tensors.

        If the computed solver exposes a differentiable factorization
        (``loglike_fn``; the hierarchical solver), the likelihood and its
        gradient flow through *that* factorization; otherwise the dense
        closed form is used.
        """
        mean = self.mean
        wn = self.white_noise
        kernel = self.kernel
        n_m = mean.full_size
        n_w = wn.full_size

        sfn = None
        if (
            self.solver is not None
            and self.solver.computed
            and hasattr(self.solver, "loglike_fn")
        ):
            sfn = self.solver.loglike_fn()

        def loglike(theta, x, y, yerr2):
            mu = mean.value_fn(theta[:n_m], x)
            wnv = wn.value_fn(theta[n_m : n_m + n_w], x)
            diag = yerr2 + torch.exp(wnv)
            if sfn is not None:
                return sfn(theta[n_m + n_w :], diag, y - mu)
            K = kernel.gram(theta[n_m + n_w :], x, x) + torch.diag(diag)
            return mahalanobis_loglike(torch.linalg.cholesky(K), y - mu)

        return loglike

    def _grad_log_likelihood_host(self, y, quiet=False):
        """Gradient for host-side (non-traceable) mean or white-noise
        models, from

            d ll / d theta = 1/2 tr[(a a^T - K^{-1}) dK/dtheta] ,
                  a = K^{-1} (y - mu)."""
        try:
            alpha = self._compute_alpha(y, False)
        except ValueError:
            if quiet:
                return np.zeros(len(self), dtype=np.float64)
            raise

        info = np.outer(alpha, alpha) - self.solver.get_inverse()

        pieces = []
        if len(self.mean):
            pieces.append(self._call_mean_gradient(self._x) @ alpha)
        if len(self.white_noise):
            scale = np.exp(self._call_white_noise(self._x)) * np.diag(info)
            jac = self._call_white_noise_gradient(self._x)
            pieces.append(0.5 * jac @ scale)
        if len(self.kernel):
            dK = self.kernel.get_gradient(self._x)  # (n, n, n_params)
            pieces.append(
                0.5 * np.tensordot(dK, info, axes=[(0, 1), (0, 1)])
            )
        return np.concatenate(pieces) if pieces else np.empty(0)

    def _grad_log_likelihood_matrix_free(self, y, quiet=False):
        """Hutchinson trace-estimated gradient through a matrix-free
        solver."""
        try:
            alpha = self._compute_alpha(y, False)
        except ValueError:
            if quiet:
                return np.zeros(len(self), dtype=np.float64)
            raise
        return self.solver.grad_log_likelihood(
            self, self._x, alpha, self.unfrozen_mask
        )

    def nll(self, vector, y, quiet=True):
        """Negative log-likelihood at ``vector`` (optimizer objective)."""
        self.set_parameter_vector(vector)
        if not np.isfinite(self.log_prior()):
            return np.inf
        return -self.log_likelihood(y, quiet=quiet)

    def grad_nll(self, vector, y, quiet=True):
        self.set_parameter_vector(vector)
        if not np.isfinite(self.log_prior()):
            return np.zeros(len(vector))
        return -self.grad_log_likelihood(y, quiet=quiet)

    # ------------------------------------------------------------------
    # alpha / inverse applications
    # ------------------------------------------------------------------

    def _compute_alpha(self, y, cache):
        if cache and self._alpha is not None and np.array_equiv(y, self._y):
            return self._alpha
        r = np.ascontiguousarray(
            self._check_dimensions(y) - self._call_mean(self._x),
            dtype=np.float64,
        )
        alpha = self.solver.apply_inverse(r, in_place=True).flatten()
        if cache:
            self._y, self._alpha = y, alpha
        return alpha

    def apply_inverse(self, y):
        """``(K + diag)^{-1} (y - mu)`` for vectors or matrices of samples."""
        self.recompute(quiet=False)
        r = np.array(y, dtype=np.float64, order="F")
        r = self._check_dimensions(r, check_dim=False)
        m = [slice(None)] + [np.newaxis for _ in range(r.ndim - 1)]
        r -= self._call_mean(self._x)[tuple(m)]
        if r.ndim == 1:
            return self.solver.apply_inverse(r, in_place=True).flatten()
        return self.solver.apply_inverse(r, in_place=True)

    # ------------------------------------------------------------------
    # Prediction
    # ------------------------------------------------------------------

    def _kernel_values(self, kernel, x1, x2=None, diag=False):
        """Kernel block (or diagonal) on the GP's device, as float64
        numpy."""
        theta = self._tensor(kernel.parameter_vector)
        a = self._tensor(x1)
        b = a if x2 is None else self._tensor(x2)
        with torch.no_grad():
            K = kernel.pair_fn(theta, a, b) if diag else kernel.gram(
                theta, a, b)
        return K.cpu().numpy().astype(np.float64)

    def predict(
        self,
        y,
        t,
        return_cov=True,
        return_var=False,
        cache=True,
        kernel=None,
    ):
        """Posterior predictive distribution at coordinates ``t``.

        Returns ``mu``, ``(mu, cov)`` or ``(mu, var)`` depending on
        ``return_cov`` / ``return_var``. A ``kernel`` override computes the
        cross-covariance with a different kernel.
        """
        self.recompute()
        alpha = self._compute_alpha(y, cache)
        xs = self.parse_samples(t)

        if kernel is None:
            kernel = self.kernel

        Kxs = self._kernel_values(kernel, xs, self._x)
        mu = np.dot(Kxs, alpha) + self._call_mean(xs)
        if not (return_var or return_cov):
            return mu

        KinvKxs = self.solver.apply_inverse(Kxs.T)
        if return_var:
            var = self._kernel_values(kernel, xs, diag=True)
            var -= np.sum(Kxs.T * KinvKxs, axis=0)
            return mu, var

        cov = self._kernel_values(kernel, xs)
        cov -= np.dot(Kxs, KinvKxs)
        return mu, cov

    # Modeling-protocol synonyms.
    def get_value(self, *args, **kwargs):
        return self.log_likelihood(*args, **kwargs)

    def get_gradient(self, *args, **kwargs):
        return self.grad_log_likelihood(*args, **kwargs)
