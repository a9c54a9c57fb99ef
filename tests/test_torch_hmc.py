# -*- coding: utf-8 -*-
"""The port's HMC/NUTS (``george_tpu_torch.sampling.hmc``) against the JAX
package's, in float64 on the CPU.

Deterministic pieces are held to the JAX functions on the same inputs: the
warmup schedule's flags exactly, the bit helpers exactly, dual averaging,
the robust final step sizes, one leapfrog step and the kinetic energy to
1e-12 (the same arithmetic in another order). The two packages draw
different random numbers, so whole samplers are held statistically, after
``tests/test_hmc.py``: moments of Gaussians, dense mass on a correlated
Gaussian, HMC, and a quadrature oracle on a 2-parameter GP posterior; and a
segmented run is held bit-identical to an unsegmented one.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import george_tpu as jgt
from george_tpu.sampling import hmc as J
import george_tpu_torch as tgt
from george_tpu_torch.sampling import hmc as T

torch.set_num_threads(2)

DEV = "cpu"


def _t(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float64))


@pytest.mark.parametrize("num_warmup", [10, 60, 150, 200, 400, 1000])
def test_warmup_schedule_flags_match(num_warmup):
    a, b = J.WarmupSchedule(num_warmup), T.WarmupSchedule(num_warmup)
    np.testing.assert_array_equal(a.in_slow, b.in_slow)
    np.testing.assert_array_equal(a.window_end, b.window_end)


def test_dual_averaging_and_final_eps_match():
    rng = np.random.default_rng(0)
    acc = rng.uniform(0, 1, (30, 5))
    dj = J._dual_averaging_init(0.1, jnp.float64, nchains=5)
    dt = T._dual_averaging_init(0.1, torch.float64, nchains=5)
    for a in acc:
        dj = J._dual_averaging_update(dj, jnp.asarray(a), 0.8)
        dt = T._dual_averaging_update(dt, _t(a), 0.8)
    for k in dj:
        np.testing.assert_allclose(dt[k].numpy(), np.asarray(dj[k]),
                                   rtol=1e-13, atol=1e-15)
    # a restart from per-chain step sizes
    eps = np.exp(np.asarray(dj["log_eps"]))
    rj, rt = J._dual_averaging_init(jnp.asarray(eps), jnp.float64), \
        T._dual_averaging_init(_t(eps), torch.float64)
    for k in rj:
        np.testing.assert_allclose(rt[k].numpy(), np.asarray(rj[k]),
                                   rtol=1e-15)
    # the robust final step sizes, with the cases of tests/test_hmc.py
    cases = [np.log([0.007, 0.0071, 0.0069, 0.08, 1e-6]),
             np.array([np.log(0.01), -np.inf, np.nan]),
             np.asarray(dj["log_eps_avg"]),
             np.array([np.nan, np.inf]),
             np.array([0.3])]
    for le in cases:
        np.testing.assert_allclose(
            T._robust_final_eps(_t(le), 2.0).numpy(),
            np.asarray(J._robust_final_eps(jnp.asarray(le), 2.0)),
            rtol=1e-14)


def test_bit_helpers_and_uturn_match():
    i = np.arange(4096)
    np.testing.assert_array_equal(T._popcount(torch.as_tensor(i)).numpy(),
                                  np.asarray(J._popcount(jnp.asarray(i))))
    np.testing.assert_array_equal(
        T._trailing_ones(torch.as_tensor(i)).numpy(),
        np.asarray(J._trailing_ones(jnp.asarray(i))))
    # the host-integer form the tree loop uses
    assert [T._popcount(k) for k in range(64)] == [
        bin(k).count("1") for k in range(64)]
    assert [T._trailing_ones(k) for k in range(64)] == [
        int(J._trailing_ones(jnp.asarray(k))) for k in range(64)]

    rng = np.random.default_rng(1)
    ql, qr, pl, pr = rng.standard_normal((4, 200, 3))
    A = rng.standard_normal((3, 3))
    sigma = A @ A.T + 0.5 * np.eye(3)
    masses = (
        (jnp.asarray([0.5, 1.0, 2.0]), _t([0.5, 1.0, 2.0])),
        ({"sigma": jnp.asarray(sigma),
          "chol": jnp.asarray(np.linalg.cholesky(sigma))},
         {"sigma": _t(sigma), "chol": _t(np.linalg.cholesky(sigma))}))
    for mj, mt in masses:
        uj = jax.vmap(lambda a, b, c, d: J._uturn(a, b, c, d, mj))(
            *map(jnp.asarray, (ql, qr, pl, pr)))
        ut = T._uturn(*map(_t, (ql, qr, pl, pr)), mt)
        np.testing.assert_array_equal(ut.numpy(), np.asarray(uj))


def _gp_pair(n=40):
    rng = np.random.default_rng(3)
    x = np.sort(rng.uniform(0, 10, n))
    y = np.sin(x) + 0.1 * rng.standard_normal(n)
    out = []
    for pkg, kw in ((jgt, {}), (tgt, {"device": DEV})):
        gp = pkg.GP(0.5 * pkg.kernels.ExpSquaredKernel(1.0),
                    white_noise=np.log(0.01), fit_white_noise=True, **kw)
        gp.compute(x, 0.1)
        out.append(gp.log_prob_fn(x, y, 0.1))
    return out, gp.get_parameter_vector()


@pytest.mark.parametrize("mass", ["diag", "dense"])
def test_leapfrog_momentum_and_kinetic_match(mass):
    """One leapfrog step of a GP log-posterior, the momentum transform of
    the same standard-normal draws and the float64 kinetic energy: the
    port (a batch of one chain, through the batched evaluator) against the
    JAX single-chain functions, 1e-12."""
    (fj, ft), v = _gp_pair()
    dim = len(v)
    rng = np.random.default_rng(4)
    if mass == "diag":
        d = rng.uniform(0.5, 2.0, dim)
        mj, mt = jnp.asarray(d), _t(d)
    else:
        A = rng.standard_normal((dim, dim))
        s = A @ A.T + 0.5 * np.eye(dim)
        L = np.linalg.cholesky(s)
        mj = {"sigma": jnp.asarray(s), "chol": jnp.asarray(L)}
        mt = {"sigma": _t(s), "chol": _t(L)}
    key = jax.random.PRNGKey(5)
    p_j = J._draw_momentum(key, mj, (dim,), jnp.float64)
    z = np.asarray(jax.random.normal(key, (dim,), jnp.float64))
    p_t = T._draw_momentum(_t(z)[None, :], mt)
    np.testing.assert_allclose(p_t[0].numpy(), np.asarray(p_j), rtol=1e-12)
    np.testing.assert_allclose(
        T._kinetic_hi(p_t, mt).numpy()[0],
        float(J._kinetic_hi(p_j, mj)), rtol=1e-13)

    vag_j = jax.jit(J._make_value_and_grad(fj))
    vag_t = T._make_value_and_grad(ft)
    q = v + 0.05
    lp_j, g_j = vag_j(jnp.asarray(q))
    lp_t, g_t = vag_t(_t(q)[None, :])
    out_j = J._leapfrog(vag_j, jnp.asarray(q), p_j, g_j, 0.07, mj)
    out_t = T._leapfrog(vag_t, _t(q)[None, :], p_t, g_t, 0.07, mt)
    for a, b in zip(out_t, out_j):
        np.testing.assert_allclose(a[0].numpy(), np.asarray(b),
                                   rtol=1e-12, atol=1e-12)


def _gaussian(mu, icov):
    mu, icov = _t(mu), _t(icov)

    def log_prob(theta):
        d = theta - mu
        return -0.5 * d @ (icov @ d)

    return log_prob


def test_nuts_recovers_gaussian_moments():
    cov = np.array([[2.0, 0.8], [0.8, 1.0]])
    mu = np.array([1.0, -0.5])
    p0 = _t(np.random.default_rng(0).standard_normal((8, 2)))
    samples, stats = T.sample_nuts(0, _gaussian(mu, np.linalg.inv(cov)), p0,
                                   num_warmup=150, num_samples=300)
    assert samples.shape == (300, 8, 2)
    flat = samples.numpy().reshape(-1, 2)
    assert np.allclose(flat.mean(0), mu, atol=0.1)
    assert np.allclose(np.cov(flat.T), cov, atol=0.3)
    assert float(stats["diverging"].double().mean()) < 0.01
    assert 0.6 < float(stats["accept"].mean()) <= 1.0
    # at most one host read per leapfrog step of the batched chains
    assert 0 < stats["host_reads"] <= stats["leapfrog_evals"]
    assert stats["step_size"].shape == (8,)


def test_nuts_dense_mass_whitens_correlated_gaussian():
    """Dense mass adaptation on a correlated, scale-disparate Gaussian
    (after ``tests/test_hmc.py:154``): the adapted inverse mass estimates
    the covariance, the trees stay shallow, the draws recover it."""
    rng = np.random.default_rng(7)
    A = rng.standard_normal((5, 5))
    cov = A @ A.T + 0.1 * np.eye(5)
    cov[0, 0] *= 100.0
    p0 = _t(rng.standard_normal((8, 5)))
    samples, stats = T.sample_nuts(0, _gaussian(np.zeros(5),
                                                np.linalg.inv(cov)), p0,
                                   num_warmup=150, num_samples=150,
                                   dense_mass=True)
    flat = samples.numpy().reshape(-1, 5)
    err = np.abs(np.cov(flat.T) - cov).max() / np.abs(cov).max()
    assert err < 0.1
    sigma = stats["inv_mass"]["sigma"].numpy()
    assert np.abs(sigma - cov).max() / np.abs(cov).max() < 0.3
    assert float(stats["depth"].double().mean()) <= 3.0


def test_hmc_recovers_standard_gaussian():
    """Fixed-length HMC (after ``tests/test_hmc.py:85``). The adapted step
    is ~0.75 here, so 5 leapfrog steps cover ~0.6 of the Gaussian's
    period; a trajectory near a whole number of periods (8 or 16 steps)
    returns to its start and mixes poorly, in either package."""
    p0 = _t(np.random.default_rng(2).standard_normal((4, 3)))
    samples, stats = T.sample_hmc(
        2, lambda th: -0.5 * torch.sum(th ** 2), p0, num_warmup=200,
        num_samples=500, num_leapfrog=5)
    flat = samples.numpy().reshape(-1, 3)
    assert np.allclose(flat.mean(0), 0.0, atol=0.12)
    assert np.allclose(flat.std(0), 1.0, atol=0.15)
    assert stats["leapfrog_evals"] == 5 * 700 and stats["host_reads"] == 0
    assert "depth" not in stats


def test_nuts_depth_reaches_max_on_straight_trajectory():
    """With a step far too small to curve the trajectory every doubling
    succeeds and every chain's tree reaches ``max_depth`` (the
    backward-subtree orientation regression of ``tests/test_hmc.py``)."""
    vag = T._make_value_and_grad(lambda th: -0.5 * torch.sum(th ** 2))
    q = torch.full((16, 4), 0.1, dtype=torch.float64)
    lp, g = vag(q)
    counts = {"leapfrog_evals": 0, "host_reads": 0}
    gen = torch.Generator().manual_seed(7)
    max_depth = 8
    draws = (torch.randn((16, 4), generator=gen, dtype=torch.float64),
             torch.rand((16, 2 * max_depth + (1 << max_depth)),
                        generator=gen, dtype=torch.float64))
    out = T.nuts_transition(draws, q, lp, g, vag,
                            torch.full((16,), 0.01, dtype=torch.float64),
                            torch.ones(4, dtype=torch.float64), max_depth,
                            counts)
    assert torch.all(out[4] == max_depth)
    assert counts["leapfrog_evals"] == (1 << max_depth) - 1
    assert counts["host_reads"] <= counts["leapfrog_evals"]


def test_segmented_nuts_is_bit_identical():
    (_, ft), v = _gp_pair(30)
    p0 = _t(v[None, :] + 1e-2 * np.random.default_rng(8).standard_normal(
        (3, len(v))))
    kw = dict(num_warmup=12, num_samples=10, max_depth=4, dense_mass=True)
    s1, st1 = T.sample_nuts(4, ft, p0, **kw)
    s2, st2 = T.sample_nuts(torch.Generator().manual_seed(4), ft, p0,
                            segment_size=7, **kw)
    assert torch.equal(s1, s2)
    for k in ("accept", "logp", "depth", "diverging", "warmup_accept",
              "step_size"):
        assert torch.equal(st1[k], st2[k]), k
    assert torch.equal(st1["inv_mass"]["sigma"], st2["inv_mass"]["sigma"])
    # another seed gives another chain
    s3, _ = T.sample_nuts(5, ft, p0, **kw)
    assert not torch.equal(s1, s3)


def test_nuts_and_hmc_classes_keep_numpy_stats():
    (_, ft), v = _gp_pair(30)
    p0 = v[None, :] + 1e-2 * np.random.default_rng(9).standard_normal(
        (2, len(v)))
    for cls, kw in ((T.NUTS, {"max_depth": 5}), (T.HMC, {"num_leapfrog": 4})):
        sampler = cls(ft, num_warmup=10, device=DEV, **kw)
        samples = sampler.run(p0, 8, seed=1)
        assert samples.shape == (8, 2, len(v))
        assert np.all(np.isfinite(samples))
        assert isinstance(sampler.stats["accept"], np.ndarray)


def test_nuts_matches_quadrature_on_gp_posterior():
    """A smaller quadrature oracle (after ``tests/test_hmc.py:206``): NUTS
    on a 2-parameter GP hyperparameter posterior with a Gaussian prior
    lands within 4 Monte-Carlo standard errors of the trapezoid-rule
    moments on a wide grid."""
    rng = np.random.default_rng(21)
    x = np.sort(rng.uniform(0, 10, 50))
    y = np.sin(x) + 0.15 * rng.standard_normal(50)
    gp = tgt.GP(0.5 * tgt.kernels.ExpSquaredKernel(1.0), device=DEV)
    gp.compute(x, 0.15)
    center = _t(gp.get_parameter_vector())
    log_prob = gp.log_prob_fn(
        x, y, 0.15, gate_prior=False,
        log_prior=lambda th: -0.5 * torch.sum((th - center) ** 2))

    g0 = np.linspace(float(center[0]) - 6.0, float(center[0]) + 6.0, 81)
    g1 = np.linspace(float(center[1]) - 6.0, float(center[1]) + 6.0, 81)
    G0, G1 = np.meshgrid(g0, g1, indexing="ij")
    pts = _t(np.stack([G0.ravel(), G1.ravel()], axis=1))
    with torch.no_grad():
        lp = torch.func.vmap(log_prob)(pts).numpy().reshape(G0.shape)
    w = np.exp(lp - lp.max())
    Z = np.trapezoid(np.trapezoid(w, g1, axis=1), g0)
    mean_q = np.array([np.trapezoid(np.trapezoid(w * G, g1, axis=1), g0) / Z
                       for G in (G0, G1)])
    sd_q = np.sqrt([np.trapezoid(np.trapezoid(
        w * (G - m) ** 2, g1, axis=1), g0) / Z
        for G, m in ((G0, mean_q[0]), (G1, mean_q[1]))])
    assert w[0].max() < 1e-8 and w[-1].max() < 1e-8
    assert w[:, 0].max() < 1e-8 and w[:, -1].max() < 1e-8

    p0 = _t(center.numpy()[None, :] + 1e-2 * rng.standard_normal((4, 2)))
    samples, _ = T.sample_nuts(2, log_prob, p0, num_warmup=60,
                               num_samples=150, max_depth=5)
    flat = samples.numpy().reshape(-1, 2)
    tol = 4.0 * sd_q / np.sqrt(flat.shape[0] / 10.0)
    assert np.all(np.abs(flat.mean(0) - mean_q) < tol), (
        flat.mean(0), mean_q, tol)
    assert np.allclose(flat.std(0), sd_q, rtol=0.25)
