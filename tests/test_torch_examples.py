# -*- coding: utf-8 -*-
"""The PyTorch twins of the examples (``george_tpu_torch/examples``) run
end to end on the CPU in float64, at the sizes ``tests/test_examples.py``
runs the JAX examples, with the examples' own asserts as the gate. Beside
each run, the deterministic numbers are held against the JAX package on
the same inputs: the JAX example module's own data functions where it has
them, and its kernels carried across by ``convert.kernel_from_reference``.
Stochastic results (fits, samplers) are held by the examples' asserts.

``bayesopt``, ``mixture`` and ``hyper`` run in
``tests/test_torch_examples_sampling.py`` (one file per xdist worker).
"""

import importlib.util
import os

import numpy as np
import torch

import george_tpu as jgt
from george_tpu_torch.convert import kernel_from_reference
from george_tpu_torch.examples import first, model, multioutput, scaling
from george_tpu_torch.examples import spatial

torch.set_num_threads(2)

DEV = "cpu"   # the twins default to the card
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_example(name):
    """The JAX package's ``examples/<name>.py`` as a module (its
    ``__main__`` block does not run)."""
    spec = importlib.util.spec_from_file_location(
        "jax_example_" + name, os.path.join(REPO, "examples", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def carried(kernel_t, kernel_j):
    """The port kernel with the JAX kernel's parameters."""
    return kernel_from_reference(kernel_t, kernel_j.get_parameter_names(),
                                 kernel_j.get_parameter_vector())


def _rel(a, b):
    return abs(a - b) / abs(b)


def test_port_example_first():
    """The starting log-likelihood against the JAX GP's (1e-10)."""
    jx = jax_example("first")
    x, y, yerr = first.generate_data()
    for a, b in zip((x, y, yerr), jx.generate_data()):
        np.testing.assert_array_equal(a, b)
    out = first.main(device=DEV)
    kj = np.var(y) * jgt.kernels.ExpSquaredKernel(0.5)
    gj = jgt.GP(kj)
    gj.compute(x, yerr)
    assert _rel(out["ll0"], gj.log_likelihood(y)) < 1e-10
    assert out["ll"] > out["ll0"] and out["rmse"] < 0.1


def test_port_example_scaling():
    """At n = 700: the exact and direct-sparse log-likelihoods against the
    JAX package's (1e-10 relative), the HODLR one within 1e-6 of the
    exact."""
    n = 700
    out = scaling.main(n, device=DEV)
    x, y, yerr = scaling.generate_data(n)
    jk = jgt.kernels
    kj = 1.0 * jk.ExpSquaredKernel(4.0) + 0.3 * jk.Matern32Kernel(2.0)
    gj = jgt.GP(kj)
    gj.compute(x, yerr)
    ll_exact = gj.log_likelihood(y)
    assert _rel(out["ll_exact"], ll_exact) < 1e-10
    assert _rel(out["ll_hodlr"], ll_exact) < 1e-6
    tapered = jk.WendlandC2Kernel(log_rc=np.log(8.0),
                                  kernel_base=1.0 * jk.ExpSquaredKernel(4.0))
    gs = jgt.GP(tapered, solver=jgt.SparseSolver)
    gs.compute(x, yerr)
    assert out["direct"]
    assert _rel(out["ll_sparse"], gs.log_likelihood(y)) < 1e-10
    assert _rel(out["ll_sparse_dense"], out["ll_sparse"]) < 1e-6
    assert out["grad_hodlr"].shape == (4,)


def test_port_example_multioutput():
    """At n_at_scale = 3000: the LCM log-likelihood at the starting
    parameters against the JAX GP's (1e-10), on the JAX example's data
    layout."""
    x, y = multioutput.generate_data()
    out = multioutput.main(3000, device=DEV)
    kj = jgt.kernels.LCMKernel(
        logBK=np.log([1.0, 0.6, 0.1, 0.1]),
        children=[jgt.kernels.ExpSquaredKernel(metric=1.0)],
        T=2, Q=1, ndim=1)
    kt = carried(multioutput.lcm_kernel(), kj)
    np.testing.assert_array_equal(kt.get_parameter_vector(),
                                  multioutput.lcm_kernel()
                                  .get_parameter_vector())
    gj = jgt.GP(kj)
    gj.compute(x, 0.05)
    assert _rel(out["ll0"], gj.log_likelihood(y)) < 1e-10
    assert out["at_scale"]["rmse"] < 0.05


def test_port_example_model():
    """The starting log-likelihood of the GP-noise model with the
    Gaussian-feature mean (its ``value_fn`` in torch) against the JAX
    example's model on the JAX example's data (1e-10), the fused
    ``log_prob_fn`` (the mean through ``value_fn``) against the host
    ``log_likelihood``, then the example itself. The twin's data is the
    JAX example's draw to 1e-5: ``np.random.multivariate_normal`` takes
    the square root of a covariance whose smallest eigenvalues are
    rounding, so the two packages' last-digit differences in the kernel
    matrix move the draw by ~1e-6."""
    jx = jax_example("model")
    t, y, yerr = model.generate_data(model.TRUTH, 50, device=DEV)
    tj, yj, yerrj = jx.generate_data(jx.TRUTH, 50)
    np.testing.assert_array_equal(t, tj)
    np.testing.assert_array_equal(yerr, yerrj)
    np.testing.assert_allclose(y, yj, rtol=0, atol=1e-5)
    t, y, yerr = tj, yj, yerrj
    gt = model.gp_noise_gp(y, device=DEV)
    gj = jgt.GP(np.var(y) * jgt.kernels.Matern32Kernel(10.0),
                mean=jx.GaussianFeature(amp=-1.0, location=0.1,
                                        log_sigma2=np.log(0.4)),
                fit_mean=True)
    assert gt.get_parameter_names() == gj.get_parameter_names()
    gt.compute(t, yerr)
    gj.compute(t, yerr)
    ll0 = gt.log_likelihood(y)
    assert _rel(ll0, gj.log_likelihood(y)) < 1e-10
    lp = gt.log_prob_fn(t[:, None], y, yerr, gate_prior=False)
    assert _rel(float(lp(torch.as_tensor(gt.get_parameter_vector()))),
                ll0) < 1e-12
    out = model.main(device=DEV)
    assert out["sd_gp"] > 0.8 * out["sd_white"]


def test_port_example_spatial():
    """At n = 1200: the dense log-likelihood against the JAX GP's
    (1e-10), on the JAX example's data."""
    n = 1200
    out = spatial.main(n, device=DEV)
    x, y, yerr, _ = spatial.generate_data(n)
    rng = np.random.default_rng(7)
    np.testing.assert_array_equal(x, rng.uniform(0, 12, (n, 2)))
    kj = 1.0 * jgt.kernels.ExpSquaredKernel([1.5, 1.5], ndim=2)
    np.testing.assert_array_equal(
        spatial.spatial_kernel().get_parameter_vector(),
        carried(spatial.spatial_kernel(), kj).get_parameter_vector())
    gj = jgt.GP(kj)
    gj.compute(x, yerr=yerr)
    assert _rel(out["ll_exact"], gj.log_likelihood(y)) < 1e-10
    assert out["err_strong"] < 0.1 * out["err_weak"]
