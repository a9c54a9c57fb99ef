# -*- coding: utf-8 -*-
"""The port's sampler-facing GP surface (``GP.log_prob_fn`` and what it
stands on) and its optimizers and ensemble sampler, held against the JAX
package in float64 on the CPU.

``log_prob_fn`` value and gradient at three thetas, on every solver path:

* dense (``BasicSolver``), the NUTS benchmark's 7-parameter model at small
  n: the same computation in both packages, 1e-10;
* HODLR, the JAX solver's pivots handed to the port (so that the two
  factorizations share their skeletons): the likelihood to 1e-10 and the
  exact gradient to 1e-8 relative, the tolerances of
  ``tests/test_torch_hodlr.py`` for this rig;
* sparse direct (exact banded Cholesky): 1e-10;
* sparse iterative (CG + SLQ with their adjoints), the JAX package's
  ``rademacher(PRNGKey(seed), (num_probes, n))`` probes handed to the port:
  1e-8 (CG stops at a 1e-10 relative residual in both packages).

Batched chains (``vmap(grad_and_value(log_prob))``) are held to a loop of
unbatched calls at 1e-12.
"""

import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import george_tpu as jgt
from george_tpu.solvers import HODLRSolver as JaxHODLR
import george_tpu.sampling as jsamp
import george_tpu_torch as tgt
from george_tpu_torch import sampling as tsamp
from george_tpu_torch.solvers import hodlr as TH

torch.set_num_threads(2)

DEV = "cpu"   # the port's entry points default to the card


def _t(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float64))


def _nuts_model(pkg, n, seed=0, **kw):
    """The NUTS benchmark's model (``benchmarks/bench_nuts.py``) at ``n``
    points: 7 parameters, white noise fitted."""
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0.0, 30.0, n))
    y = np.sin(x) * np.exp(-0.05 * x) + 0.1 * rng.standard_normal(n)
    k = pkg.kernels
    kernel = 0.5 * k.ExpSquaredKernel(1.3) * k.ExpSine2Kernel(
        gamma=2.0, log_period=0.0) + 0.1 * k.Matern32Kernel(2.0)
    gp = pkg.GP(kernel, white_noise=np.log(1e-4), fit_white_noise=True,
                **kw)
    gp.compute(x, 0.1)
    return gp, x, y


def _hodlr_model(pkg, monkeypatch=None, ref=None, **kw):
    """A HODLR GP (3 levels at n = 600) with a fitted mean and white
    noise; the port takes the JAX solver's pivots ``ref``."""
    rng = np.random.default_rng(11)
    n = 600
    x = np.sort(rng.uniform(0, 40.0, n))
    y = np.sin(0.3 * x) + 0.3 * rng.standard_normal(n)
    if ref is not None:
        def jax_pivots(pair_fn, theta, xpad, valid, struct):
            for mine, theirs in zip(struct.levels, ref.levels):
                mine["row_piv"] = np.asarray(theirs["row_piv"])
                mine["col_piv"] = np.asarray(theirs["col_piv"])
            struct._build_flat()

        monkeypatch.setattr(TH, "select_aca_pivots", jax_pivots)
    solver = JaxHODLR if pkg is jgt else tgt.HODLRSolver
    gp = pkg.GP(1.1 * pkg.kernels.ExpSquaredKernel(2.0), mean=0.1,
                fit_mean=True, white_noise=np.log(0.5), fit_white_noise=True,
                solver=solver, min_size=64, rank=16, seed=42, **kw)
    gp.compute(x, 0.7)
    return gp, x, y


def _sparse_model(pkg, direct, **kw):
    rng = np.random.default_rng(21)
    n = 400
    x = np.sort(rng.uniform(0, 25, n))
    y = np.sin(x) + 0.1 * rng.standard_normal(n)
    k = pkg.kernels.WendlandC2Kernel(
        log_rc=np.log(1.5), kernel_base=pkg.kernels.ExpSquaredKernel(1.0))
    gp = pkg.GP(k, solver=pkg.SparseSolver, mean=0.1, fit_mean=True,
                white_noise=np.log(0.01), fit_white_noise=True,
                direct=direct, seed=42, **kw)
    gp.compute(x, 0.1)
    return gp, x, y


def _pair(path, monkeypatch):
    """JAX and port GPs for one solver path, with the data and yerr."""
    if path == "dense":
        gj, x, y = _nuts_model(jgt, 80)
        gt, _, _ = _nuts_model(tgt, 80, device=DEV)
        return gj, gt, x, y, 0.1
    if path == "hodlr":
        gj, x, y = _hodlr_model(jgt)
        gt, _, _ = _hodlr_model(tgt, monkeypatch, gj.solver._struct,
                                device=DEV)
        assert gt.solver._struct.L == gj.solver._struct.L == 3
        return gj, gt, x, y, 0.7
    direct = "auto" if path == "sparse_direct" else False
    gj, x, y = _sparse_model(jgt, direct)
    kw = {}
    if direct is False:
        kw["probes"] = np.array(jax.random.rademacher(
            jax.random.PRNGKey(42), (16, len(x)), dtype=jnp.float64))
    gt, _, _ = _sparse_model(tgt, direct, device=DEV, **kw)
    assert (gt.solver._band_factors is not None) == (direct == "auto")
    return gj, gt, x, y, 0.1


_TOL = {"dense": (1e-10, 1e-10), "hodlr": (1e-10, 1e-8),
        "sparse_direct": (1e-10, 1e-10), "sparse_iterative": (1e-8, 1e-8)}


@pytest.mark.parametrize("path", list(_TOL))
def test_log_prob_matches_reference_on_every_path(path, monkeypatch):
    gj, gt, x, y, yerr = _pair(path, monkeypatch)
    fj = jax.jit(jax.value_and_grad(gj.log_prob_fn(x, y, yerr)))
    ft = gt.log_prob_fn(x, y, yerr)
    v0 = gj.get_parameter_vector()
    assert np.array_equal(v0, gt.get_parameter_vector())
    steps = np.random.default_rng(1).standard_normal((2, len(v0)))
    tol_v, tol_g = _TOL[path]
    for theta in (v0, v0 + 0.05 * steps[0], v0 - 0.05 * steps[1]):
        lj, g_j = fj(jnp.asarray(theta))
        g_t, lt = torch.func.grad_and_value(ft)(_t(theta))
        assert abs(float(lt) - float(lj)) <= tol_v * abs(float(lj))
        np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=tol_g,
                                   atol=tol_g * np.abs(g_j).max())


def test_log_prob_prior_gate_and_frozen_mask():
    gj, x, y = _nuts_model(jgt, 40)
    gt, _, _ = _nuts_model(tgt, 40, device=DEV)
    v = gj.get_parameter_vector()
    cj, ct = jnp.asarray(v), _t(v)
    fj = gj.log_prob_fn(x, y, 0.1, gate_prior=False,
                        log_prior=lambda th: -0.5 * jnp.sum((th - cj) ** 2))
    ft = gt.log_prob_fn(x, y, 0.1, gate_prior=False,
                        log_prior=lambda th: -0.5 * torch.sum((th - ct) ** 2))
    th = v + 0.3
    lj, g_j = jax.jit(jax.value_and_grad(fj))(jnp.asarray(th))
    g_t, lt = torch.func.grad_and_value(ft)(_t(th))
    assert abs(float(lt) - float(lj)) <= 1e-10 * abs(float(lj))
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=1e-10)

    # the bounds gate: -inf outside the box, the likelihood inside
    k = tgt.kernels.ExpSquaredKernel(1.0, metric_bounds=[(-2.0, 2.0)])
    gb = tgt.GP(2.0 * k, device=DEV)
    gb.compute(x[:20], 0.1)
    fb = gb.log_prob_fn(x[:20], y[:20], 0.1)
    vb = gb.get_parameter_vector()
    assert float(fb(_t(vb))) == pytest.approx(gb.log_likelihood(y[:20]),
                                              rel=1e-12)
    vb[-1] = 5.0
    assert float(fb(_t(vb))) == -np.inf
    assert float(gb.log_prob_fn(x[:20], y[:20], 0.1, gate_prior=False)(
        _t(vb))) > -np.inf

    # a frozen parameter stays at its value; the function takes the rest
    name = gt.get_parameter_names()[3]
    for g in (gj, gt):
        g.freeze_parameter(name)
    vf = gj.get_parameter_vector()
    assert vf.shape == (6,)
    lj = jax.jit(gj.log_prob_fn(x, y, 0.1))(jnp.asarray(vf + 0.1))
    lt = gt.log_prob_fn(x, y, 0.1)(_t(vf + 0.1))
    assert abs(float(lt) - float(lj)) <= 1e-10 * abs(float(lj))
    gt.set_parameter_vector(vf + 0.1)
    assert float(lt) == pytest.approx(gt.log_likelihood(y), rel=1e-12)


def test_log_prob_refuses_mismatched_x():
    rng = np.random.default_rng(21)
    x = np.sort(rng.uniform(0, 10, 128))
    y = np.sin(x)
    for solver, kw in ((tgt.HODLRSolver, {}),
                       (tgt.SparseSolver, {"direct": False})):
        kernel = (1.2 * tgt.kernels.ExpSquaredKernel(2.0)
                  if solver is tgt.HODLRSolver else
                  tgt.kernels.WendlandC2Kernel(
                      log_rc=0.0,
                      kernel_base=tgt.kernels.ExpSquaredKernel(1.0)))
        gp = tgt.GP(kernel, solver=solver, device=DEV, **kw)
        gp.compute(x, 0.1)
        gp.log_prob_fn(x, y, 0.1)
        with pytest.raises(ValueError):
            gp.log_prob_fn(x + 0.5, y, 0.1)
    # the dense path assembles on whatever x it is given
    gp = tgt.GP(1.2 * tgt.kernels.ExpSquaredKernel(2.0), device=DEV)
    gp.compute(x, 0.1)
    assert np.isfinite(float(gp.log_prob_fn(x + 0.5, y, 0.1)(
        _t(gp.get_parameter_vector()))))


def _matern_hodlr(n=600):
    rng = np.random.default_rng(0)
    x = np.sort(rng.uniform(0, 40, n))
    y = np.sin(x) + 0.1 * rng.standard_normal(n)
    gp = tgt.GP(1.1 * tgt.kernels.Matern32Kernel(0.5),
                white_noise=np.log(0.1), fit_white_noise=True,
                solver=tgt.HODLRSolver, min_size=64, rank=8, device=DEV)
    gp.compute(x, 0.1)
    return gp, x, y


@pytest.mark.parametrize("path", ["dense", "hodlr", "sparse_iterative",
                                  "sparse_direct"])
def test_batched_chains_match_a_loop(path, monkeypatch):
    """``vmap(grad_and_value(log_prob))`` over 3 chains against a loop of
    unbatched calls, 1e-12. The HODLR rig is a Matern32 kernel at rank 8,
    below the couplings' numerical rank, so the skeleton gram is well
    conditioned (at the ridge floor the batched and unbatched BLAS orders
    differ by ~1e-10 in the gradient); the leaf Cholesky is called once
    for all chains. On the sparse iterative path the CG and SLQ Functions
    run the chains one after another under ``vmap``, as the banded
    likelihood's forward does on the direct path (its selected-inverse
    backward is batched)."""
    if path == "dense":
        gp, x, y = _nuts_model(tgt, 60, device=DEV)
    elif path == "hodlr":
        gp, x, y = _matern_hodlr()
    else:
        direct = "auto" if path == "sparse_direct" else False
        gp, x, y = _sparse_model(tgt, direct, device=DEV)
        assert (gp.solver._band_factors is not None) == (
            path == "sparse_direct")
    f = gp.log_prob_fn(x, y, 0.1)
    rng = np.random.default_rng(2)
    v = gp.get_parameter_vector()
    thetas = _t(v[None, :] + 0.02 * rng.standard_normal((3, len(v))))
    calls = []
    from george_tpu_torch.ops import chol

    forward = chol._forward
    monkeypatch.setattr(chol, "_forward",
                        lambda A: calls.append(A.shape) or forward(A))
    g, val = torch.func.vmap(torch.func.grad_and_value(f))(thetas)
    if path == "hodlr":
        B = gp.solver._struct.n_pad // gp.solver._struct.m
        assert calls == [(3 * B, gp.solver._struct.m, gp.solver._struct.m)]
    for i in range(3):
        g1, v1 = torch.func.grad_and_value(f)(thetas[i])
        assert abs(float(val[i] - v1)) <= 1e-12 * abs(float(v1))
        np.testing.assert_allclose(g[i].numpy(), g1.numpy(), rtol=1e-12,
                                   atol=1e-12 * float(g1.abs().max()))


def test_residual_fn_and_check_fused_thetas(monkeypatch):
    gj, x, y = _hodlr_model(jgt)
    gt, _, _ = _hodlr_model(tgt, monkeypatch, gj.solver._struct, device=DEV)
    v = gj.get_parameter_vector()
    n_mw = 2          # mean and white-noise parameters lead the vector
    diag = np.full(len(x), 0.7 ** 2) + np.exp(v[1])
    r = y - v[0]
    rj = float(jax.jit(gj.solver.residual_fn())(
        jnp.asarray(v[n_mw:]), jnp.asarray(diag), jnp.asarray(r)))
    rt = float(gt.solver.residual_fn()(_t(v[n_mw:]), _t(diag), _t(r)))
    assert rt < 1e-10 and abs(rt - rj) <= 1e-8 * max(rj, 1e-16) + 1e-14
    thetas = v[None, None, :] + 0.05 * np.random.default_rng(3)\
        .standard_normal((5, 2, len(v)))
    out = gt.check_fused_thetas(thetas, y, 0.7)
    assert out["ok"] and out["residuals"].shape[0] == out["thetas"].shape[0]
    assert out["max"] < 1e-6
    # an absurd tolerance fails and warns
    with pytest.warns(UserWarning):
        assert not gt.check_fused_thetas(thetas, y, 0.7, tol=0.0)["ok"]
    # dense solvers have no residual monitor
    gd, xd, yd = _nuts_model(tgt, 30, device=DEV)
    assert gd.check_fused_thetas(thetas[..., :7], yd, 0.1) is None


def test_apply_sqrt_sample_and_matrices():
    gj, x, y = _nuts_model(jgt, 50)
    gt, _, _ = _nuts_model(tgt, 50, device=DEV)
    r = np.random.default_rng(4).standard_normal((3, 50))
    np.testing.assert_allclose(gt.solver.apply_sqrt(r),
                               gj.solver.apply_sqrt(r), rtol=1e-10,
                               atol=1e-12)
    t = np.linspace(0, 30, 17)
    np.testing.assert_allclose(gt.get_matrix(t), gj.get_matrix(t),
                               rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(gt.get_matrix(t, x), gj.get_matrix(t, x),
                               rtol=1e-12, atol=1e-14)
    np.random.seed(0)
    s = gt.sample(size=4)
    assert s.shape == (4, 50) and np.all(np.isfinite(s))
    np.random.seed(0)
    s1 = gt.sample(size=1)
    assert s1.shape == (50,)
    assert gt.sample(t, size=3).shape == (3, 17)
    assert gt.sample_conditional(y, t, size=2).shape == (2, 17)
    # the trivial solver's transport is the noise scale
    gk = tgt.GP(device=DEV)
    gk.compute(x, 0.3)
    np.testing.assert_allclose(gk.solver.apply_sqrt(r[:1]),
                               0.3 * r[:1] * np.sqrt(1 + 1.25e-12 / 0.09),
                               rtol=1e-12)


def test_deprecated_aliases_and_pickling():
    gt, x, y = _nuts_model(tgt, 40, device=DEV)
    with pytest.warns(DeprecationWarning):
        assert gt.lnlikelihood(y) == gt.log_likelihood(y)
    with pytest.warns(DeprecationWarning):
        np.testing.assert_array_equal(gt.grad_lnlikelihood(y),
                                      gt.grad_log_likelihood(y))
    assert gt._fused is not None
    g2 = pickle.loads(pickle.dumps(gt))
    assert g2._fused is None
    assert g2.log_likelihood(y) == pytest.approx(gt.log_likelihood(y),
                                                 rel=1e-12)


def test_minimize_reaches_the_reference_optimum():
    rng = np.random.default_rng(1)
    x = np.sort(rng.uniform(0, 10, 80))
    y = np.sin(x) + 0.1 * rng.standard_normal(80)
    res = {}
    for pkg, kw in ((jgt, {}), (tgt, {"device": DEV})):
        gp = pkg.GP(np.var(y) * pkg.kernels.Matern52Kernel(3.0), **kw)
        gp.compute(x, 0.1)
        ll0 = gp.log_likelihood(y)
        mod = jsamp if pkg is jgt else tsamp
        r = mod.minimize(gp, y, options={"gtol": 1e-12, "ftol": 1e-15})
        assert gp.log_likelihood(y) >= ll0
        res[pkg] = r.x
    np.testing.assert_allclose(res[tgt], res[jgt], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("batched", [False, True])
def test_fit_adam_matches_reference(batched):
    """50 Adam steps on a dense GP posterior, from one start or a batch of
    three, against the JAX package's: 1e-10."""
    gj, x, y = _nuts_model(jgt, 40)
    gt, _, _ = _nuts_model(tgt, 40, device=DEV)
    v = gj.get_parameter_vector()
    theta0 = v if not batched else v[None, :] + 0.05 * np.random.\
        default_rng(5).standard_normal((3, len(v)))
    tj, trj = jsamp.fit_adam(gj.log_prob_fn(x, y, 0.1), jnp.asarray(theta0),
                             num_steps=50, learning_rate=0.02)
    tt, trt = tsamp.fit_adam(gt.log_prob_fn(x, y, 0.1), _t(theta0),
                             num_steps=50, learning_rate=0.02)
    assert tt.shape == theta0.shape and trt.shape == np.asarray(trj).shape
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), rtol=1e-10,
                               atol=1e-10)
    np.testing.assert_allclose(trt.numpy(), np.asarray(trj), rtol=1e-10)


def test_ensemble_recovers_gaussian_moments():
    """The stretch-move sampler on a correlated Gaussian (after
    ``tests/test_sampling.py:15``), batched walkers."""
    cov = np.array([[2.0, 0.8], [0.8, 1.0]])
    icov = _t(np.linalg.inv(cov))
    mu = np.array([1.0, -0.5])
    mut = _t(mu)

    def log_prob(theta):
        d = theta - mut
        return -0.5 * d @ icov @ d

    nw = 64
    sampler = tsamp.EnsembleSampler(nw, 2, log_prob, device=DEV)
    p0 = mu + np.random.default_rng(1).standard_normal((nw, 2))
    final, logp = sampler.run_mcmc(p0, 1200, seed=2)
    assert final.shape == (nw, 2) and logp.shape == (nw,)
    assert sampler.chain.shape == (nw, 1200, 2)
    assert sampler.lnprobability.shape == (nw, 1200)
    flat = sampler.flatchain[nw * 400:]
    assert np.allclose(flat.mean(axis=0), mu, atol=0.12)
    assert np.allclose(np.cov(flat.T), cov, atol=0.3)
    assert 0.2 < sampler.acceptance_fraction.mean() < 0.9
    # thinning keeps every thin-th sweep of the same stream
    s2 = tsamp.EnsembleSampler(nw, 2, log_prob, device=DEV)
    s2.run_mcmc(p0, 40, seed=2, thin=4)
    s3 = tsamp.EnsembleSampler(nw, 2, log_prob, device=DEV)
    s3.run_mcmc(p0, 40, seed=2)
    np.testing.assert_array_equal(s2.chain, s3.chain[:, 3::4])
    with pytest.raises(ValueError):
        tsamp.EnsembleSampler(3, 2, log_prob, device=DEV)


def test_ensemble_step_on_a_gp_posterior():
    gp, x, y = _nuts_model(tgt, 40, device=DEV)
    f = torch.func.vmap(gp.log_prob_fn(x, y, 0.1))
    v = gp.get_parameter_vector()
    w = _t(v[None, :] + 1e-3 * np.random.default_rng(6).standard_normal(
        (16, len(v))))
    lp = f(w)
    w2, lp2, acc = tsamp.ensemble_step(7, w, lp, f)
    assert w2.shape == w.shape and bool(torch.isfinite(lp2).all())
    assert 0.0 <= float(acc) <= 1.0
    np.testing.assert_allclose(lp2.numpy(), f(w2).numpy(), rtol=1e-12)
