# -*- coding: utf-8 -*-
"""The user-facing GP object (PyTorch port of ``george_tpu/gp.py``).

* The covariance is the kernel's broadcast block function
  (``kernels/base.py``), evaluated on the GP's ``device`` in its ``dtype``.
* Solvers factorize on that device; the solver is built from
  ``solver=`` with the same ``device`` and ``dtype``.
* ``grad_log_likelihood`` is autograd of the whole marginal likelihood
  through the solver's differentiable factorization (``loglike_fn``) or,
  for a solver without one, through a dense Cholesky. A matrix-free
  solver (HODLR with ``grad_mode="hutchinson"``, the sparse and H-matrix
  solvers) supplies only its kernel block and ``diag(a a^T - K^{-1})``,
  exact or Hutchinson-estimated (``gradient_terms``); the GP adds the mean
  and white-noise blocks (``_assemble_gradient``).
* ``log_prob_fn`` is the samplers' surface: a pure function of the active
  parameter tensor through the same fused likelihood, which composes with
  ``torch.func.grad`` and ``vmap`` over chains (``sampling/``).

``compute(x, yerr)`` takes the vanilla george argument order; neighbor
structures are the optional keyword ``nns``.
"""

import warnings

import numpy as np
import torch

from . import kernels
from .diagnostics import annotate, count_host_read
from .modeling import ModelSet, ConstantModel, Model, CallableModel
from .neighbors import normalize_nns
from .solvers import TrivialSolver, BasicSolver
from .solvers.linalg import mahalanobis_loglike
from .utils import multivariate_gaussian_samples

__all__ = ["GP", "TINY"]

# Tiny diagonal jitter (as the default white-noise level) keeping K positive
# definite in the absence of observational uncertainties.
TINY = 1.25e-12

# what a failed factorization or likelihood raises, by source
_FAILURES = (ValueError, np.linalg.LinAlgError, torch.linalg.LinAlgError)

# The posterior takes its test points in blocks whose float64 (n, k)
# columns hold at most this many bytes: a block's widest buffers (the
# solver's float64 cascade, the variance's products) scale with n k, so the
# device peak stays bounded however many points a call predicts.
_PREDICT_BLOCK_BYTES = 256 * 2 ** 20


def _blocks(m, n):
    """Slices of ``m`` test points against ``n`` data points, each within
    ``_PREDICT_BLOCK_BYTES``: as few as fit, of equal sizes (cuBLAS picks
    slower kernels for the HODLR cascade at 335 + 165 columns than at
    250 + 250 on an H100)."""
    count = -(-m // max(1, _PREDICT_BLOCK_BYTES // (8 * n)))
    size = max(1, -(-m // count))
    return [slice(a, min(a + size, m)) for a in range(0, m, size)]


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
        self._alpha_t = None
        self._x_t = None
        self._y = None
        self._fused = None
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

        # the previous solver (its factors and CUDA graph, held by the
        # fused functions and the cached solve too) goes before the next
        # factorization, so that the two never share the device
        self.solver = None
        self._alpha = None
        self._alpha_t = None
        self._x_t = None
        self._fused = None  # the solver is baked into the fused functions
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

    def lnlikelihood(self, y, quiet=False):
        warnings.warn(
            "'lnlikelihood' is deprecated. Use 'log_likelihood'",
            DeprecationWarning,
        )
        return self.log_likelihood(y, quiet=quiet)

    def grad_lnlikelihood(self, y, quiet=False):
        warnings.warn(
            "'grad_lnlikelihood' is deprecated. Use 'grad_log_likelihood'",
            DeprecationWarning,
        )
        return self.grad_log_likelihood(y, quiet=quiet)

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
            _, g = self._fused_value_and_grad()(
                self._tensor(self.parameter_vector),
                self._tensor(self._x),
                self._tensor(self._check_dimensions(y)),
                self._tensor(self._yerr2),
            )
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

        If the computed solver exposes a differentiable likelihood
        (``loglike_fn``; the hierarchical and sparse solvers), the value and
        its gradient flow through *that* factorization; otherwise the dense
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
            # a matrix that is not positive definite gives NaN (as JAX's
            # Cholesky does), not an exception: under vmap one bad chain
            # must not stop the others
            L, info = torch.linalg.cholesky_ex(K)
            return torch.where(info == 0,
                               mahalanobis_loglike(L, y - mu), torch.nan)

        return loglike

    def log_prob_fn(self, x, y, yerr=0.0, gate_prior=True, log_prior=None):
        """A pure ``f(theta_active) -> log-posterior`` on tensors.

        The returned function evaluates the fused (assemble -> factor ->
        solve -> logdet) marginal likelihood at an *active* (unfrozen)
        parameter tensor on the GP's device, holding the data constant, and
        returns a scalar tensor. It composes with ``torch.func.grad`` and
        ``torch.func.vmap`` (the samplers evaluate every chain's value and
        gradient as ``vmap(grad_and_value(f))``). Uniform-prior bounds gate
        the result to ``-inf`` outside the box (``gate_prior``); non-finite
        likelihoods map to ``-inf`` so samplers reject instead of
        propagating NaN.

        ``log_prior`` may be a ``theta_active -> scalar`` function in torch
        ops, added to the likelihood. Gradient-based samplers want a smooth
        prior here rather than the hard box: a GP marginal likelihood
        typically plateaus as amplitudes and scales run off to infinity, so
        without a proper prior the posterior is improper and NUTS
        trajectories run to maximum depth.

        When the solver provides a fused likelihood (``loglike_fn``), ``x``
        must be the computed inputs: the solver evaluates the covariance on
        the points it sorted and padded in :func:`compute`.
        """
        if not self._traceable:
            raise ValueError(
                "log_prob_fn requires traceable mean/white-noise models"
            )
        x = self.parse_samples(x)
        if (
            self.solver is not None
            and self.solver.computed
            and hasattr(self.solver, "loglike_fn")
            and not np.array_equal(x, self._x)
        ):
            raise ValueError(
                "log_prob_fn: x must match the computed inputs when the "
                "solver provides a fused likelihood (call gp.compute(x, "
                "...) with these points first)"
            )
        xt = self._tensor(x)
        yt = self._tensor(np.atleast_1d(y))
        yerr2 = self._yerr2_tensor(yerr, yt.shape[0])
        loglike = self._fused_loglike_full()
        frozen, order = self._active_gather()
        bounds = self.get_parameter_bounds()
        lo = self._tensor([-np.inf if b[0] is None else float(b[0])
                           for b in bounds])
        hi = self._tensor([np.inf if b[1] is None else float(b[1])
                           for b in bounds])

        def log_prob(theta_active):
            theta_active = theta_active.to(self.dtype)
            theta = torch.cat([theta_active, frozen])[order]
            ll = loglike(theta, xt, yt, yerr2)
            ll = torch.where(torch.isfinite(ll), ll, -np.inf)
            if log_prior is not None:
                ll = ll + log_prior(theta_active)
                ll = torch.where(torch.isfinite(ll), ll, -np.inf)
            if gate_prior:
                inside = torch.all((theta_active >= lo) & (theta_active <= hi))
                ll = torch.where(inside, ll, -np.inf)
            return ll

        return log_prob

    def _yerr2_tensor(self, yerr, n):
        try:
            return float(yerr) ** 2 * torch.ones(n, dtype=self.dtype,
                                                 device=self.device)
        except TypeError:
            return self._tensor(np.asarray(yerr, dtype=np.float64) ** 2)

    def _active_gather(self):
        """``(frozen, order)``: the full parameter vector is
        ``cat([theta_active, frozen])[order]``, a gather that ``vmap``
        batches and that copies each value exactly."""
        mask = self.unfrozen_mask
        (active_idx,) = np.nonzero(mask)
        (frozen_idx,) = np.nonzero(~mask)
        order = np.empty(len(mask), dtype=np.int64)
        order[active_idx] = np.arange(len(active_idx))
        order[frozen_idx] = len(active_idx) + np.arange(len(frozen_idx))
        frozen = self._tensor(self.parameter_vector[frozen_idx])
        return frozen, torch.as_tensor(order, device=self.device)

    def check_fused_thetas(self, thetas, y, yerr=0.0, max_evals=16,
                           tol=None, warn=True):
        """Post-hoc factorization health check over sampler-visited thetas.

        The fused ``log_prob_fn`` never checks its factorization, so a
        chain walking a kernel component into a regime where the
        hierarchical cascade goes unstable would get wrong
        log-probabilities silently. Run this after sampling: it evaluates
        the solver's relative solve residual ``|K z - r| / |r|``
        (``residual_fn``) at the per-dimension extreme thetas plus an even
        subsample of the chain, and warns when any exceeds ``tol``
        (default 1e-6 in float64, 1e-2 in float32).

        ``thetas`` are ACTIVE parameter vectors, shape ``(..., ndim)``;
        ``y``/``yerr`` the computed dataset. Returns ``{"thetas",
        "residuals", "max", "ok"}``, or ``None`` when the computed solver
        has no fused residual monitor (dense and CG-based solvers control
        their residual by construction).
        """
        if not (
            self.solver is not None
            and self.solver.computed
            and hasattr(self.solver, "residual_fn")
        ):
            return None
        x = self._tensor(self._x)
        yt = self._tensor(np.atleast_1d(y))
        yerr2 = self._yerr2_tensor(yerr, yt.shape[0])
        mean, wn = self.mean, self.white_noise
        n_m, n_w = mean.full_size, wn.full_size
        rfn = self.solver.residual_fn()
        frozen, order = self._active_gather()

        def residual(theta_active):
            theta = torch.cat([self._tensor(theta_active), frozen])[order]
            with torch.no_grad():
                mu = mean.value_fn(theta[:n_m], x)
                wnv = wn.value_fn(theta[n_m:n_m + n_w], x)
                return float(rfn(theta[n_m + n_w:], yerr2 + torch.exp(wnv),
                                 yt - mu))

        th = np.asarray(thetas, dtype=np.float64)
        th = th.reshape(-1, th.shape[-1])
        th = th[np.all(np.isfinite(th), axis=1)]
        if th.shape[0] == 0:
            return {"thetas": th, "residuals": np.empty(0),
                    "max": 0.0, "ok": True}
        # per-dimension extremes + an even subsample, deduplicated
        idx = set()
        for d in range(th.shape[1]):
            idx.add(int(np.argmin(th[:, d])))
            idx.add(int(np.argmax(th[:, d])))
        for i in np.linspace(0, th.shape[0] - 1,
                             max(max_evals - len(idx), 2)).astype(int):
            idx.add(int(i))
        idx = sorted(idx)[:max(max_evals, 2 * th.shape[1])]
        picked = th[idx]
        res = np.array([residual(t) for t in picked])
        if tol is None:
            tol = 1e-6 if self.dtype == torch.float64 else 1e-2
        bad = ~(res < tol)  # NaN residuals count as failures
        out = {"thetas": picked, "residuals": res,
               "max": float(np.nanmax(res)) if np.isfinite(res).any()
               else float("inf"),
               "ok": not bool(bad.any())}
        if warn and bad.any():
            worst = int(np.nanargmax(np.where(np.isfinite(res), res,
                                              np.inf)))
            warnings.warn(
                "fused-path factorization residual check failed at %d of "
                "%d sampled thetas (worst |Kz-r|/|r| = %.2e at theta=%s, "
                "tol %.0e): the chain visited a regime where the "
                "hierarchical factorization is unstable (typically a "
                "non-decaying kernel component growing dominant) — "
                "log-probabilities there are unreliable. Restrict the "
                "prior, or use BasicSolver at these scales."
                % (int(bad.sum()), len(res), out["max"],
                   np.array2string(picked[worst], precision=3), tol),
                stacklevel=2,
            )
        return out

    def _fused_value_and_grad(self):
        """``(theta_full, x, y, yerr2) -> (loglike, d loglike / d theta)``
        through the fused likelihood, cached until the next compute."""
        if self._fused is None:
            loglike = self._fused_loglike_full()

            def value_and_grad(theta, x, y, yerr2):
                theta = theta.detach().requires_grad_(True)
                ll = loglike(theta, x, y, yerr2)
                (g,) = torch.autograd.grad(ll, theta)
                return ll.detach(), g

            self._fused = value_and_grad
        return self._fused

    def _assemble_gradient(self, alpha, g_kernel, diag_A):
        """The gradient over the active parameters, ``[mean, white noise,
        kernel]``, from ``a = K^{-1} (y - mu)``, the kernel block over the
        kernel's full parameter vector and ``diag_A = diag(a a^T -
        K^{-1})``:

            d ll / d mean = (d mu)^T a,
            d ll / d wn   = 1/2 (d wn)^T (e^{wn} * diag_A),

        both in the original point order."""
        pieces = []
        if len(self.mean):
            pieces.append(self._call_mean_gradient(self._x) @ alpha)
        if len(self.white_noise):
            scale = np.exp(self._call_white_noise(self._x)) * diag_A
            pieces.append(
                0.5 * self._call_white_noise_gradient(self._x) @ scale)
        pieces.append(np.asarray(g_kernel)[self.kernel.unfrozen_mask])
        return np.concatenate(pieces)

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
        dK = self.kernel.get_gradient(self._x, include_frozen=True,
                                      device=self.device)  # (n, n, T)
        g_kernel = 0.5 * np.tensordot(dK, info, axes=[(0, 1), (0, 1)])
        return self._assemble_gradient(alpha, g_kernel, np.diag(info))

    def _grad_log_likelihood_matrix_free(self, y, quiet=False):
        """Gradient through a matrix-free solver: its kernel block and
        ``diag(a a^T - K^{-1})``, exact or Hutchinson-estimated."""
        try:
            alpha = self._compute_alpha(y, False)
        except ValueError:
            if quiet:
                return np.zeros(len(self), dtype=np.float64)
            raise
        g = self._assemble_gradient(alpha, *self.solver.gradient_terms(alpha))
        if getattr(self.solver, "debug", False):
            self._debug_gradient_check(y, g)
        return g

    def _debug_gradient_check(self, y, g_est):
        """Under the solver's ``debug``: the dense exact gradient beside the
        matrix-free estimate, so the compression and Monte-Carlo error of
        the estimate is visible (``debug_gradient``; printed when the
        solver is ``verbose``). It assembles dense ``(n, n)`` matrices, in
        float64 on the GP's device, and is skipped with a warning above
        n = 20000."""
        n = len(self._x)
        self.debug_gradient = None
        if n > 20000:
            warnings.warn(
                "debug gradient comparison skipped at n=%d (it "
                "materializes dense O(n^2) matrices)" % n
            )
            return None
        f64, dev = torch.float64, self.device
        x = torch.as_tensor(self._x, dtype=f64, device=dev)
        theta = torch.as_tensor(self.kernel.parameter_vector, dtype=f64,
                                device=dev)
        diag = torch.as_tensor(
            self._yerr2 + np.exp(self._call_white_noise(self._x)),
            dtype=f64, device=dev)
        r = torch.as_tensor(
            np.asarray(self._check_dimensions(y), dtype=np.float64)
            - self._call_mean(self._x), dtype=f64, device=dev)
        with torch.no_grad():
            K = self.kernel.gram(theta, x, x)
            K.diagonal().add_(diag)
            L = torch.linalg.cholesky(K)
            del K
            alpha = torch.cholesky_solve(r[:, None], L)[:, 0]
            # the information matrix a a^T - K^{-1}, of which every
            # gradient piece is a contraction
            info = torch.outer(alpha, alpha) - torch.cholesky_inverse(L)
            del L
        # one forward-mode derivative of the gram per active parameter
        g_kernel = np.zeros(len(theta))
        for i in np.flatnonzero(self.kernel.unfrozen_mask):
            tangent = torch.zeros_like(theta)
            tangent[i] = 1.0
            _, dK = torch.func.jvp(
                lambda th: self.kernel.gram(th, x, x), (theta,), (tangent,))
            g_kernel[i] = 0.5 * float(torch.sum(dK * info))
            del dK
        g_exact = self._assemble_gradient(
            alpha.cpu().numpy(), g_kernel, info.diagonal().cpu().numpy())
        g_est = np.asarray(g_est, dtype=np.float64)
        rep = {
            "exact": g_exact,
            "estimated": g_est,
            "max_abs_delta": float(np.max(np.abs(g_exact - g_est)))
            if g_exact.size else 0.0,
        }
        self.debug_gradient = rep
        if getattr(self.solver, "verbose", False):
            print(g_exact, "grad_exact")
            print(g_est, "grad_estimated")
        return rep

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
            self._y, self._alpha, self._alpha_t = y, alpha, None
        return alpha

    def _alpha_device(self, y, cache):
        """:meth:`_compute_alpha`'s answer as a float64 tensor on the GP's
        device, cached (and invalidated) with it."""
        alpha = self._compute_alpha(y, cache)
        if not cache:
            return torch.as_tensor(alpha, device=self.device)
        if self._alpha_t is None:
            self._alpha_t = torch.as_tensor(alpha, device=self.device)
        return self._alpha_t

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
    # Prediction and sampling
    # ------------------------------------------------------------------

    def _posterior(self, kernel, xs, alpha, out):
        """The posterior at the test points ``xs`` (numpy ``(m, d)``) as
        float64 tensors on the GP's device: ``(mu, None)`` for ``out=None``,
        ``(mu, var)`` for ``"var"``, ``(mu, cov)`` for ``"cov"``, without
        the mean model.

        ``mu = Kxs alpha`` and ``cov = prior - Kxs K^{-1} Kxs^T`` (``var``
        its diagonal), with the cross block evaluated as ``Kxs^T = K(x,
        xs)`` in the working dtype and the products and sums in float64:
        the posterior variance is a small difference of the prior. The test
        points go through in blocks (:func:`_blocks`), each block's columns
        of ``Kxs^T`` through the solver's ``solve_columns``. The spans are
        ``gp.predict.cross_cov`` (the cross block, then the prior) and
        ``gp.predict.solve`` (every block's solve and reduction)."""
        f64 = torch.float64
        theta = self._tensor(kernel.parameter_vector)
        if self._x_t is None:
            self._x_t = self._tensor(self._x)
        x = self._x_t
        ts = self._tensor(xs)
        blocks = _blocks(len(xs), len(x))
        with torch.no_grad():
            with annotate("gp.predict.cross_cov"):
                # Kxs^T by blocks of columns, the layout of the solves
                K = [kernel.gram(theta, x, ts[b]) for b in blocks]
            mu = torch.cat([Kc.to(f64).mT @ alpha for Kc in K])
            if out is None:
                return mu, None
            with annotate("gp.predict.cross_cov"):
                prior = (kernel.pair_fn(theta, ts, ts) if out == "var"
                         else kernel.gram(theta, ts, ts)).to(f64)
            with annotate("gp.predict.solve"):
                parts = []
                for Kc in K:
                    Z = self.solver.solve_columns(Kc).to(f64)
                    if out == "var":
                        parts.append(torch.sum(Kc.to(f64) * Z, dim=0))
                    else:
                        parts.append(torch.cat([Kd.to(f64).mT @ Z
                                                for Kd in K]))
                    del Z           # before the next block's solve
                return mu, prior - torch.cat(parts, dim=int(out == "cov"))

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

        The posterior stays on the GP's device (:meth:`_posterior`) and is
        read to the host once, at the end. Under a profiler the call is the
        span ``gp.predict``, each kernel block ``gp.predict.cross_cov`` and
        the solve ``gp.predict.solve``.
        """
        with annotate("gp.predict"):
            self.recompute()
            alpha = self._alpha_device(y, cache)
            xs = self.parse_samples(t)

            if kernel is None:
                kernel = self.kernel

            out = "var" if return_var else ("cov" if return_cov else None)
            mu, second = self._posterior(kernel, xs, alpha, out)
            rows = [mu[None]]
            if second is not None:
                rows.append(second.reshape(-1, len(xs)))
            count_host_read()
            host = torch.cat(rows).cpu().numpy()
            mu = host[0] + self._call_mean(xs)
            if out is None:
                return mu
            return mu, host[1] if out == "var" else host[1:]

    def sample_conditional(self, y, t, size=1):
        """Samples from the predictive conditional distribution."""
        mu, cov = self.predict(y, t)
        return multivariate_gaussian_samples(cov, size, mean=mu)

    def sample(self, t=None, size=1):
        """Samples from the prior distribution (at ``t``, or at the
        computed coordinates through the solver's ``apply_sqrt``)."""
        if t is None:
            self.recompute()
            n, _ = self._x.shape
            results = np.array(self.solver.apply_sqrt(
                np.random.randn(size, n)))
            results += self._call_mean(self._x)
            return results[0] if size == 1 else results

        x = self.parse_samples(t)
        cov = self.get_matrix(x)
        cov[np.diag_indices_from(cov)] += TINY
        return multivariate_gaussian_samples(
            cov, size, mean=self._call_mean(x)
        )

    def get_matrix(self, x1, x2=None):
        """The covariance matrix at coordinates ``x1`` (cross-covariance
        against ``x2`` if given), evaluated on the GP's device, as float64
        numpy."""
        x1 = self.parse_samples(x1)
        if x2 is None:
            return self.kernel.get_value(x1, device=self.device)
        return self.kernel.get_value(x1, self.parse_samples(x2),
                                     device=self.device)

    # Modeling-protocol synonyms.
    def get_value(self, *args, **kwargs):
        return self.log_likelihood(*args, **kwargs)

    def get_gradient(self, *args, **kwargs):
        return self.grad_log_likelihood(*args, **kwargs)

    def __getstate__(self):
        state = self.__dict__.copy()
        state["_fused"] = None
        state["_alpha_t"] = state["_x_t"] = None   # device copies
        return state

    def __setstate__(self, state):
        state.setdefault("_alpha_t", None)
        state.setdefault("_x_t", None)
        self.__dict__.update(state)
