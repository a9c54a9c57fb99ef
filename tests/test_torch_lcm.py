# -*- coding: utf-8 -*-
"""The port's multi-output ``LCMKernel`` held against the JAX package's, in
float64 on the CPU: parameter names and carry-over, the pair function and
its gradient on random points and tasks, the log-likelihood through the
dense and the hierarchical solver (which orders and partitions on the
kernel's ``sort_axes``), and ``log_prob_fn`` over batched chains."""

import numpy as np
import pytest
import torch

import george_tpu as jgt
from george_tpu import kernels as jk
import george_tpu_torch as tgt
from george_tpu_torch import convert
from george_tpu_torch import kernels as tk
from george_tpu_torch.solvers import hodlr as TH

torch.set_num_threads(2)

DEV = "cpu"   # the port's entry points default to the card


def _lcm(pkg, logBK, T, Q):
    children = [pkg.ExpSquaredKernel(2.0), pkg.Matern32Kernel(1.0)][:Q]
    return pkg.LCMKernel(logBK, children=children, T=T, Q=Q, ndim=1)


def _lcm_data(n_per=200, T=2, Q=2, seed=0):
    """The multitask rig of ``tests/test_hodlr.py`` at a smaller size."""
    rng = np.random.default_rng(seed)
    xs = np.sort(rng.uniform(0, 30.0, n_per * T))
    task = np.tile(np.arange(T), n_per).astype(float)
    x = np.column_stack([xs, task])
    logBK = np.log(rng.uniform(0.3, 1.5, 2 * T * Q))
    y = rng.standard_normal(n_per * T)
    return logBK, x, y, 0.3 * np.ones(n_per * T)


@pytest.mark.parametrize("T,Q", [(2, 1), (3, 2)])
def test_lcm_pair_fn_matches_reference(T, Q):
    rng = np.random.default_rng(T * 10 + Q)
    logBK = np.log(rng.uniform(0.3, 1.5, 2 * T * Q))
    kj, kt = _lcm(jk, logBK, T, Q), _lcm(tk, logBK, T, Q)
    assert kt.get_parameter_names() == kj.get_parameter_names()
    assert kt.get_parameter_names()[:2 * T * Q] == tuple(
        ["logB_%d_%d" % (t, q) for t in range(T) for q in range(Q)]
        + ["logK_%d_%d" % (t, q) for t in range(T) for q in range(Q)])
    np.testing.assert_array_equal(kt.get_parameter_vector(),
                                  kj.get_parameter_vector())
    assert kt.input_ndim == kj.input_ndim == 2
    assert kt.sort_axes == kj.sort_axes == [0]
    x1 = np.column_stack([rng.uniform(0, 5, 37), rng.integers(0, T, 37)])
    x2 = np.column_stack([rng.uniform(0, 5, 23), rng.integers(0, T, 23)])
    Kj, Kt = kj.get_value(x1, x2), kt.get_value(x1, x2, device=DEV)
    np.testing.assert_allclose(Kt, Kj, rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(kt.get_value(x1, diag=True, device=DEV),
                               kj.get_value(x1, diag=True), rtol=1e-12)
    np.testing.assert_allclose(kt.get_gradient(x1, x2, device=DEV),
                               kj.get_gradient(x1, x2), rtol=1e-10,
                               atol=1e-12)
    with pytest.raises(ValueError):
        kt.get_value(x1[:, :1], device=DEV)


def test_lcm_parameters_carry_over():
    """``convert.kernel_from_reference`` sets the nested children's
    parameters along with the coregionalization ones."""
    logBK = np.log([1.0, 0.7, 0.3, 0.2, 0.5, 0.9, 0.4, 0.6])
    kj = _lcm(jk, logBK, 2, 2)
    kj.set_parameter_vector(kj.get_parameter_vector() + 0.1)
    kt = _lcm(tk, logBK, 2, 2)
    convert.kernel_from_reference(kt, kj.get_parameter_names(),
                                  kj.get_parameter_vector())
    np.testing.assert_array_equal(kt.get_parameter_vector(),
                                  kj.get_parameter_vector())
    assert kt.children[1].get_parameter_vector()[0] == pytest.approx(
        kj.get_parameter_vector()[-1])
    x = np.column_stack([np.linspace(0, 3, 9), np.arange(9) % 2])
    np.testing.assert_allclose(kt.get_value(x, device=DEV), kj.get_value(x),
                               rtol=1e-12)
    with pytest.raises(ValueError):
        tk.LCMKernel(logBK[:3], [tk.ExpSquaredKernel(1.0)], T=2, Q=1)
    with pytest.raises(ValueError):
        tk.LCMKernel(logBK[:4], [], T=2, Q=1)


def test_lcm_basic_gp_matches_reference():
    logBK, x, y, yerr = _lcm_data(n_per=100)
    gj = jgt.GP(_lcm(jk, logBK, 2, 2))
    gt = tgt.GP(_lcm(tk, logBK, 2, 2), device=DEV)
    for gp in (gj, gt):
        gp.compute(x, yerr)
    lj, lt = gj.log_likelihood(y), gt.log_likelihood(y)
    assert abs(lt - lj) / abs(lj) < 1e-10
    np.testing.assert_allclose(gt.grad_log_likelihood(y),
                               gj.grad_log_likelihood(y), rtol=1e-8)
    t = np.column_stack([np.linspace(1, 29, 17), np.ones(17)])
    np.testing.assert_allclose(gt.predict(y, t, return_cov=False),
                               gj.predict(y, t, return_cov=False),
                               rtol=1e-8, atol=1e-10)


def test_lcm_hodlr_matches_reference_and_dense(monkeypatch):
    """Through the hierarchical solver: ordered on the spatial axis only
    (the port's permutation is the JAX solver's), the likelihood within
    1e-9 of the JAX solver's on its pivots and within 1e-6 of the dense
    oracle, the exact gradient within 1e-4 of the dense one."""
    logBK, x, y, yerr = _lcm_data()
    kw = dict(min_size=64, rank=24)
    gj = jgt.GP(_lcm(jk, logBK, 2, 2), solver=jgt.HODLRSolver, **kw)
    gj.compute(x, yerr)
    ref = gj.solver._struct

    def jax_pivots(pair_fn, theta, xpad, valid, struct):
        for mine, theirs in zip(struct.levels, ref.levels):
            mine["row_piv"] = np.asarray(theirs["row_piv"])
            mine["col_piv"] = np.asarray(theirs["col_piv"])
        struct._build_flat()

    monkeypatch.setattr(TH, "select_aca_pivots", jax_pivots)
    gt = tgt.GP(_lcm(tk, logBK, 2, 2), solver=tgt.HODLRSolver, device=DEV,
                **kw)
    gt.compute(x, yerr)
    np.testing.assert_array_equal(gt.solver._perm, gj.solver._perm)
    # tasks interleave along the spatial order
    assert np.all(np.diff(x[gt.solver._perm, 0]) >= 0)
    lj, lt = gj.log_likelihood(y), gt.log_likelihood(y)
    assert abs(lt - lj) / abs(lj) < 1e-9

    gd = tgt.GP(_lcm(tk, logBK, 2, 2), device=DEV)
    gd.compute(x, yerr)
    ld = gd.log_likelihood(y)
    assert abs(lt - ld) / abs(ld) < 1e-6
    g, g_true = gt.grad_log_likelihood(y), gd.grad_log_likelihood(y)
    assert np.max(np.abs(g - g_true)) / np.max(np.abs(g_true)) < 1e-4
    t = np.column_stack([np.linspace(1, 29, 20), np.ones(20)])
    mu_h, var_h = gt.predict(y, t, return_var=True)
    mu_d, var_d = gd.predict(y, t, return_var=True)
    assert np.max(np.abs(mu_h - mu_d)) < 1e-5
    assert np.max(np.abs(var_h - var_d)) < 1e-5


def test_lcm_log_prob_fn_over_chains():
    """``log_prob_fn`` with the LCM kernel composes with ``vmap`` and
    ``grad`` (the task ids gather the coregionalization weights by integer
    indexing): chains against single calls and the GP's likelihood."""
    from george_tpu_torch.sampling import hmc

    logBK, x, y, yerr = _lcm_data(n_per=60, Q=1)
    logBK = logBK[:4]
    gp = tgt.GP(_lcm(tk, logBK, 2, 1), solver=tgt.HODLRSolver, min_size=32,
                rank=16, device=DEV)
    gp.compute(x, yerr)
    f = gp.log_prob_fn(x, y, yerr, gate_prior=False)
    v0 = gp.get_parameter_vector()
    th = torch.as_tensor(v0[None, :] + 0.05 * np.random.default_rng(
        1).standard_normal((3, len(v0))))
    lp, g = hmc._make_value_and_grad(f)(th)
    for c in range(3):
        g1, v1 = torch.func.grad_and_value(f)(th[c])
        assert float(v1) == pytest.approx(float(lp[c]), rel=1e-10)
        # the exact gradient goes through the skeleton solves at their
        # ridge floor, which amplify the batched summation order (measured
        # 2.5e-8 relative on one component)
        np.testing.assert_allclose(g[c].numpy(), g1.numpy(), rtol=1e-6,
                                   atol=1e-6 * float(g1.abs().max()))
    assert float(f(torch.as_tensor(v0))) == pytest.approx(
        gp.log_likelihood(y), rel=1e-9)
