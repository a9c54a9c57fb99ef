# -*- coding: utf-8 -*-
"""Variational inference (ADVI) over the fused GP likelihood (PyTorch port
of ``george_tpu/sampling/vi.py``).

A Gaussian approximation of the posterior fitted by stochastic
reparameterized ELBO ascent: mean-field (diagonal) or full-rank (a dense
Cholesky covariance; GP hyperparameter posteriors are strongly
correlated, where mean-field underestimates the variance). The
Monte-Carlo draws of a step are one batched evaluation
(``torch.func.vmap`` of the log-probability); the Adam loop is a host
loop. The ELBOs take their standard-normal draws ``eps`` as an argument
(:func:`_elbo_meanfield`, :func:`_elbo_fullrank`), and the Adam loop takes
them as a stream (``_fit``), so that a test can hand both the draws of
another implementation.
"""

import math

import numpy as np
import torch

from . import _random

__all__ = ["fit_advi", "fit_advi_fullrank", "advi_sample", "ADVI"]


def _adam_scan(value_and_grad, params0, eps_of, num_steps, learning_rate):
    """Adam ascent with cosine decay of the rate to 5% (it tames the
    Monte-Carlo gradient noise at the ELBO plateau); ``eps_of(i)`` gives
    step ``i``'s draws. Returns ``(params, trace of values)``."""
    b1, b2, adam_eps = 0.9, 0.999, 1e-8
    params = tuple(params0)
    m = tuple(torch.zeros_like(p) for p in params)
    v = tuple(torch.zeros_like(p) for p in params)
    trace = []
    for i in range(num_steps):
        g, val = value_and_grad(params, eps_of(i))
        g = tuple(torch.where(torch.isfinite(x), x, 0.0) for x in g)
        m = tuple(b1 * mm + (1 - b1) * gg for mm, gg in zip(m, g))
        v = tuple(b2 * vv + (1 - b2) * gg * gg for vv, gg in zip(v, g))
        t = i + 1.0
        lr = learning_rate * (
            0.05 + 0.95 * 0.5 * (1.0 + math.cos(math.pi * i / num_steps)))
        params = tuple(
            p + lr * (mm / (1 - b1 ** t))
            / (torch.sqrt(vv / (1 - b2 ** t)) + adam_eps)
            for p, mm, vv in zip(params, m, v))
        trace.append(val)
    return params, torch.stack(trace)


def _entropy(log_diag):
    dim = log_diag.shape[0]
    return torch.sum(log_diag) + 0.5 * dim * (1.0 + math.log(2.0 * math.pi))


def _mean_lp(batched_lp, theta):
    lp = batched_lp(theta)
    return torch.mean(torch.where(torch.isfinite(lp), lp, -1e30))


def _elbo_meanfield(params, eps, batched_lp):
    """Mean-field ELBO at ``params = (mu, log_sigma)`` on the draws ``eps``
    ``(num_samples, dim)``."""
    mu, log_sigma = params
    theta = mu[None, :] + torch.exp(log_sigma)[None, :] * eps
    return _mean_lp(batched_lp, theta) + _entropy(log_sigma)


def _chol_of(params):
    _, log_d, W = params
    return torch.tril(W, -1) + torch.diag(torch.exp(log_d))


def _elbo_fullrank(params, eps, batched_lp):
    """Full-rank ELBO at ``params = (mu, log_d, W)`` (``L = tril(W, -1) +
    diag(exp(log_d))``); the entropy of the reparameterized Gaussian is
    ``sum(log_d) + const``, so the ELBO stays exact in the Cholesky
    parameterization."""
    theta = params[0][None, :] + eps @ _chol_of(params).mT
    return _mean_lp(batched_lp, theta) + _entropy(params[1])


def _fit(elbo, log_prob_fn, params0, num_steps, eps_of, learning_rate):
    """Adam ascent of ``elbo`` from ``params0``, step ``i`` on the draws
    ``eps_of(i)``. Returns ``(params, trace)``."""
    batched_lp = torch.func.vmap(log_prob_fn)
    vag = torch.func.grad_and_value(
        lambda params, e: elbo(params, e, batched_lp))
    with torch.no_grad():
        return _adam_scan(vag, params0, eps_of, int(num_steps),
                          float(learning_rate))


def _draws(key, theta0, num_steps, num_samples):
    """``eps_of(i)``: step ``i``'s standard-normal draws ``(num_samples,
    dim)``, from a generator seeded per step (``_random.py``)."""
    seeds = _random.step_seeds(key, num_steps)

    def eps_of(i):
        gen = _random.step_generator(seeds[i], theta0.device)
        return torch.randn((num_samples, theta0.shape[0]), generator=gen,
                           dtype=theta0.dtype, device=theta0.device)

    return eps_of


def _as_vector(theta0, device):
    if isinstance(theta0, torch.Tensor):
        return theta0
    return torch.as_tensor(np.asarray(theta0), device=device)


def fit_advi(key, log_prob_fn, theta0, num_steps=1000, num_samples=8,
             learning_rate=0.02, device="cuda"):
    """Fit ``q(theta) = N(mu, diag(exp(2 log_sigma)))`` to the posterior.

    ``key``: a ``torch.Generator`` or an int seed; ``theta0`` a tensor (on
    its device) or an array (on ``device``). Returns ``(mu, log_sigma,
    elbo_trace)``."""
    theta0 = _as_vector(theta0, device)
    params0 = (theta0, -2.0 * torch.ones_like(theta0))
    (mu, log_sigma), trace = _fit(
        _elbo_meanfield, log_prob_fn, params0, num_steps,
        _draws(key, theta0, num_steps, num_samples), learning_rate)
    return mu, log_sigma, trace


def fit_advi_fullrank(key, log_prob_fn, theta0, num_steps=1000,
                      num_samples=8, learning_rate=0.02, device="cuda"):
    """Fit ``q(theta) = N(mu, L L^T)`` with a dense lower-triangular ``L``
    (log-parameterized diagonal); arguments as :func:`fit_advi`. Returns
    ``(mu, L, elbo_trace)``."""
    theta0 = _as_vector(theta0, device)
    dim = theta0.shape[0]
    params0 = (theta0, -2.0 * torch.ones_like(theta0),
               theta0.new_zeros((dim, dim)))
    params, trace = _fit(
        _elbo_fullrank, log_prob_fn, params0, num_steps,
        _draws(key, theta0, num_steps, num_samples), learning_rate)
    return params[0], _chol_of(params), trace


def advi_sample(key, mu, scale, num_samples):
    """Draw from the fitted posterior: ``scale`` is the mean-field
    ``log_sigma`` vector or the full-rank Cholesky factor ``L``; draws are
    made on ``mu``'s device."""
    gen = key if isinstance(key, torch.Generator) else \
        _random.step_generator(key, mu.device)
    eps = torch.randn((int(num_samples), mu.shape[0]), generator=gen,
                      dtype=mu.dtype, device=mu.device)
    if scale.ndim == 2:
        return mu[None, :] + eps @ scale.mT
    return mu[None, :] + torch.exp(scale)[None, :] * eps


class ADVI(object):
    """Stateful wrapper mirroring the sampler APIs.

    ``full_rank=True`` fits a dense-covariance Gaussian (Cholesky
    parameterization): use it whenever the posterior correlations matter,
    which for GP hyperparameters is essentially always. ``device`` is where
    a ``theta0`` given as an array is placed (default ``"cuda"``)."""

    def __init__(self, log_prob_fn, num_steps=1000, num_samples=8,
                 learning_rate=0.02, full_rank=False, device="cuda"):
        self.log_prob_fn = log_prob_fn
        self.num_steps = int(num_steps)
        self.num_samples = int(num_samples)
        self.learning_rate = float(learning_rate)
        self.full_rank = bool(full_rank)
        self.device = torch.device(device)
        self.mu = None
        self.log_sigma = None
        self.chol = None
        self.elbo_trace = None

    def fit(self, theta0, seed=0):
        """Returns ``(mu, sigma)`` as numpy, ``sigma`` the per-parameter
        posterior standard deviations (marginal, for full-rank)."""
        fitter = fit_advi_fullrank if self.full_rank else fit_advi
        mu, scale, trace = fitter(
            seed, self.log_prob_fn, _as_vector(theta0, self.device),
            num_steps=self.num_steps, num_samples=self.num_samples,
            learning_rate=self.learning_rate)
        self._mu_t, self._scale_t = mu, scale
        self.mu = mu.cpu().numpy()
        self.elbo_trace = trace.cpu().numpy()
        if self.full_rank:
            self.chol = scale.cpu().numpy()
            sigma = np.sqrt(np.sum(self.chol ** 2, axis=1))
            self.log_sigma = np.log(sigma)
            return self.mu, sigma
        self.log_sigma = scale.cpu().numpy()
        return self.mu, np.exp(self.log_sigma)

    @property
    def covariance(self):
        """Fitted posterior covariance (diagonal for mean-field)."""
        if self.full_rank:
            return self.chol @ self.chol.T
        return np.diag(np.exp(2.0 * self.log_sigma))

    def sample(self, num_samples, seed=1):
        return advi_sample(seed, self._mu_t, self._scale_t,
                           num_samples).cpu().numpy()
