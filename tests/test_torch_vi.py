# -*- coding: utf-8 -*-
"""The port's ADVI (``george_tpu_torch.sampling.vi``) against the JAX
package's, in float64 on the CPU.

The ELBO and its Adam ascent are held to the JAX fit on the same draws:
the JAX fit draws ``eps_i = normal(split(key, num_steps)[i], (num_samples,
dim))``; those draws are handed to the port's Adam loop (``_fit``), and the
ELBO trace, the mean and the scale after 25 steps agree to 1e-10 (the same
arithmetic in another summation order). Fits from the port's own draws are
held statistically, after ``tests/test_vi.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import george_tpu as jgt
from george_tpu.sampling import vi as JV
import george_tpu_torch as tgt
from george_tpu_torch.sampling import vi as TV

torch.set_num_threads(2)

DEV = "cpu"


def _t(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float64))


def _gp_log_probs(n=40):
    rng = np.random.default_rng(0)
    x = np.sort(rng.uniform(0, 10, n))
    y = np.sin(x) + 0.1 * rng.standard_normal(n)
    out = []
    for pkg, kw in ((jgt, {}), (tgt, {"device": DEV})):
        gp = pkg.GP(0.5 * pkg.kernels.ExpSquaredKernel(1.0),
                    white_noise=np.log(0.01), fit_white_noise=True, **kw)
        gp.compute(x, 0.1)
        out.append(gp.log_prob_fn(x, y, 0.1, gate_prior=False))
    return out, gp.get_parameter_vector()


@pytest.mark.parametrize("full_rank", [False, True])
def test_advi_elbo_and_fit_match_reference(full_rank):
    (fj, ft), v = _gp_log_probs()
    steps, S, dim = 25, 8, len(v)
    key = jax.random.PRNGKey(3)
    eps = np.stack([np.asarray(jax.random.normal(k, (S, dim), jnp.float64))
                    for k in jax.random.split(key, steps)])
    fit_j = JV.fit_advi_fullrank if full_rank else JV.fit_advi
    elbo = TV._elbo_fullrank if full_rank else TV._elbo_meanfield
    mj, sj, trj = fit_j(key, fj, jnp.asarray(v), num_steps=steps,
                        num_samples=S, learning_rate=0.05)
    params0 = ((_t(v), -2.0 * torch.ones(dim, dtype=torch.float64),
                torch.zeros((dim, dim), dtype=torch.float64))
               if full_rank else
               (_t(v), -2.0 * torch.ones(dim, dtype=torch.float64)))
    params, trt = TV._fit(elbo, ft, params0, steps, lambda i: _t(eps[i]),
                          0.05)
    mt, st = params[0], (TV._chol_of(params) if full_rank else params[1])
    np.testing.assert_allclose(trt.numpy(), np.asarray(trj), rtol=1e-10)
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), rtol=1e-10,
                               atol=1e-10)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-10,
                               atol=1e-10)

    # the ELBO alone, and its gradient, on the first step's draws
    g, val = torch.func.grad_and_value(elbo)(
        params0, _t(eps[0]), torch.func.vmap(ft))
    assert float(val) == pytest.approx(float(trj[0]), rel=1e-12)
    assert all(bool(torch.isfinite(x).all()) for x in g)
    # the fit's own draws: a seed gives the same fit twice
    fit_t = TV.fit_advi_fullrank if full_rank else TV.fit_advi
    a = fit_t(7, ft, _t(v), num_steps=3, num_samples=S, device=DEV)
    b = fit_t(7, ft, _t(v), num_steps=3, num_samples=S, device=DEV)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_advi_recovers_gaussian():
    mu_t = _t([1.0, -2.0, 0.5])
    sigma_t = _t([0.5, 1.5, 0.2])

    def log_prob(theta):
        return -0.5 * torch.sum(((theta - mu_t) / sigma_t) ** 2)

    advi = TV.ADVI(log_prob, num_steps=1500, learning_rate=0.05, device=DEV)
    mu, sigma = advi.fit(np.zeros(3), seed=0)
    assert np.allclose(mu, mu_t.numpy(), atol=0.1)
    assert np.allclose(sigma, sigma_t.numpy(), rtol=0.25)
    s = advi.sample(2000, seed=1)
    assert s.shape == (2000, 3)
    assert np.allclose(s.mean(0), mu_t.numpy(), atol=0.15)
    assert np.allclose(advi.covariance, np.diag(sigma ** 2), rtol=1e-12)


def test_advi_fullrank_recovers_correlated_gaussian():
    rng = np.random.default_rng(5)
    A = rng.standard_normal((3, 3))
    cov_t = A @ A.T + 0.2 * np.eye(3)
    mu_t = np.array([0.5, -1.0, 2.0])
    prec, mu = _t(np.linalg.inv(cov_t)), _t(mu_t)

    def log_prob(theta):
        d = theta - mu
        return -0.5 * d @ (prec @ d)

    advi = TV.ADVI(log_prob, num_steps=2500, learning_rate=0.05,
                   full_rank=True, device=DEV)
    m, sigma = advi.fit(np.zeros(3), seed=0)
    assert np.allclose(m, mu_t, atol=0.1)
    cov = advi.covariance
    assert np.allclose(cov, cov_t, atol=0.25 * np.abs(cov_t).max())
    corr_t = cov_t[0, 1] / np.sqrt(cov_t[0, 0] * cov_t[1, 1])
    corr = cov[0, 1] / np.sqrt(cov[0, 0] * cov[1, 1])
    assert abs(corr - corr_t) < 0.15
    assert np.allclose(sigma, np.sqrt(np.diag(cov)), rtol=1e-12)
    s = advi.sample(4000, seed=1)
    assert np.allclose(np.cov(s.T), cov_t, atol=0.3 * np.abs(cov_t).max())
