# -*- coding: utf-8 -*-
"""The twins of the examples that fit and sample (``bayesopt``,
``mixture``, ``hyper --smoke``) on the CPU in float64, their own asserts
the gate, with their deterministic numbers (the data and the starting
log-likelihoods) held against the JAX package's. The rest of the twins
run in ``tests/test_torch_examples.py``."""

import numpy as np
import torch

import george_tpu as jgt
import george_tpu_torch as tgt
from george_tpu_torch.examples import bayesopt, hyper, mixture

from test_torch_examples import DEV, _rel, carried, jax_example

torch.set_num_threads(2)


def test_port_example_bayesopt():
    """The objective and EI are the JAX example's; the loop finds the
    global minimum within its evaluation budget."""
    jx = jax_example("bayesopt")
    grid = np.linspace(-5, 5, 101)
    np.testing.assert_array_equal(bayesopt.objective(grid),
                                  jx.objective(grid))
    mu, var = np.sin(grid), 0.1 + grid ** 2
    np.testing.assert_array_equal(
        bayesopt.expected_improvement(mu, var, -0.2),
        jx.expected_improvement(mu, var, -0.2))
    out = bayesopt.main(device=DEV)
    assert abs(out["est_min"] - out["true_min"]) < 0.05
    assert out["n_evals"] <= 34


def test_port_example_mixture():
    """The mixture's starting log-likelihood against the JAX GP's on the
    twin's data (1e-10), then the example (component extraction)."""
    X, y, yerr, _ = mixture.generate_data(device=DEV)
    jk = jgt.kernels
    kj = (2.0 * jk.Matern32Kernel([5.0, 0.5], ndim=2)
          + 2.0 * jk.ExpSine2Kernel(gamma=10.0, log_period=np.log(5.0),
                                    ndim=2, axes=0)
          * jk.ExpSquaredKernel([15.0], ndim=2, axes=0))
    gj = jgt.GP(kj)
    gj.compute(X, yerr)
    gt = tgt.GP(carried(mixture.mixture_kernel(), kj), device=DEV)
    gt.compute(X, yerr)
    assert _rel(gt.log_likelihood(y), gj.log_likelihood(y)) < 1e-10
    out = mixture.main(device=DEV)
    assert out["corr_recovered"] > 0.9


def test_port_example_hyper():
    """``hyper --smoke``: the data is the JAX example's, the user
    ``log_prior`` is a torch function; the three engines agree (the
    example's asserts)."""
    x, y, yerr, _ = hyper.generate_data()
    rng = np.random.default_rng(42)
    np.testing.assert_array_equal(x, np.sort(rng.uniform(0, 10, 80)))
    out = hyper.main(smoke=True, device=DEV)
    assert np.allclose(out["ensemble_mean"], out["nuts_mean"], atol=0.2)
    assert np.allclose(out["advi_mean"], out["nuts_mean"], atol=0.4)
