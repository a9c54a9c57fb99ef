# -*- coding: utf-8 -*-
"""The port's kernel zoo held against the JAX package's.

Every spec-generated kernel (metric variants, algebra, blocks) is built in
both packages with the same constructor arguments and evaluated on the
same seeded points, in float64 on the CPU. Values agree to 1e-12 and
hyperparameter gradients to 1e-10 relative: the formulas are the same, only
the operation order differs (broadcast blocks here, a vmap of a scalar pair
function there, autodiff in both).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from george_tpu import kernels as jk
from george_tpu_torch import convert
from george_tpu_torch import kernels as tk
from george_tpu_torch.kernels.base import safe_sqrt

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _zoo(K):
    """``(id, kernel)`` pairs built from the kernel module ``K``: every
    generated kernel class, the metric types, algebra and blocks."""
    out = [
        ("constant", K.ConstantKernel(log_constant=0.1)),
        ("dotproduct", K.DotProductKernel()),
        ("cosine", K.CosineKernel(log_period=1.0)),
        ("expsine2", K.ExpSine2Kernel(gamma=0.4, log_period=1.0)),
        ("localgaussian",
         K.LocalGaussianKernel(location=0.5, log_width=0.1)),
        ("linear", K.LinearKernel(log_gamma2=0.3, order=2)),
        ("polynomial", K.PolynomialKernel(log_sigma2=0.2, order=2)),
        ("empty", K.EmptyKernel()),
        ("ratquad", K.RationalQuadraticKernel(log_alpha=0.3, metric=1.2)),
        ("ratquad-axis", K.RationalQuadraticKernel(
            log_alpha=0.3, metric=[0.5, 2.0], ndim=2)),
    ]
    for name, cls in (("expsq", K.ExpSquaredKernel), ("exp", K.ExpKernel),
                      ("matern32", K.Matern32Kernel),
                      ("matern52", K.Matern52Kernel)):
        out += [
            (name + "-iso1", cls(metric=1.0, ndim=1)),
            (name + "-iso2", cls(metric=0.5, ndim=2)),
            (name + "-axis", cls(metric=[0.5, 1.5], ndim=2)),
            (name + "-general", cls(
                metric=np.array([[1.0, 0.2], [0.2, 2.0]]), ndim=2)),
            (name + "-subspace", cls(metric=1.0, ndim=3, axes=[0, 2])),
        ]
    out += [
        ("sum", K.ExpSquaredKernel(metric=1.0)
         + K.Matern32Kernel(metric=2.0)),
        ("product", K.ExpSquaredKernel(metric=1.0)
         * K.ExpSine2Kernel(gamma=0.3, log_period=0.5)),
        ("scaled", 3.0 * K.Matern52Kernel(metric=0.7)),
        ("shifted", 1.0 + K.ExpKernel(metric=1.3)),
        ("block", K.ExpSquaredKernel(metric=1.0, block=[(-0.2, 0.7)])),
        # the two bench workloads: smooth and quasi-periodic
        ("bench-smooth", 1.2 * K.ExpSquaredKernel(25.0)
         + 0.3 * K.Matern32Kernel(8.0)),
        ("bench-qp", 1.0 * K.ExpSquaredKernel(20.0) * K.ExpSine2Kernel(
            gamma=1.0, log_period=np.log(3.7))),
    ]
    return out


IDS = [name for name, _ in _zoo(tk)]


def _pair(idx):
    return _zoo(jk)[idx][1], _zoo(tk)[idx][1]


def _points(kernel, n, seed):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1.0, 1.0, (n, kernel.ndim))


def test_zoo_covers_every_generated_kernel():
    from george_tpu_torch.kernels import generated

    classes = {n for n in generated.__all__ if not n.startswith("Base")}
    built = {type(k).__name__ for _, k in _zoo(tk)}
    for _, k in _zoo(tk):
        built |= {type(m).__name__ for m in getattr(k, "models", {}).values()}
    assert classes <= built, classes - built


@pytest.mark.parametrize("idx", range(len(IDS)), ids=IDS)
def test_value_and_gradient_match_reference(idx):
    kj, kt = _pair(idx)
    assert tuple(kt.get_parameter_names()) == tuple(
        kj.get_parameter_names())
    np.testing.assert_array_equal(kt.get_parameter_vector(),
                                  kj.get_parameter_vector())
    x1 = _points(kt, 7, 123)
    x2 = _points(kt, 5, 321)

    for args in ((x1,), (x1, x2)):
        vj = np.asarray(kj.get_value(*args))
        vt = kt.get_value(*args, device="cpu")
        assert vt.shape == vj.shape
        scale = np.abs(vj).max(initial=1e-300)
        np.testing.assert_allclose(vt, vj, rtol=1e-12, atol=1e-12 * scale)

        gj = np.asarray(kj.get_gradient(*args))
        gt = kt.get_gradient(*args, device="cpu")
        assert gt.shape == gj.shape
        gscale = np.abs(gj).max(initial=1e-300)
        np.testing.assert_allclose(gt, gj, rtol=1e-10, atol=1e-10 * gscale)

    dj = np.asarray(kj.get_value(x1, x1, diag=True))
    dscale = np.abs(dj).max(initial=1e-300)
    np.testing.assert_allclose(kt.get_value(x1, x1, diag=True, device="cpu"),
                               dj,
                               rtol=1e-12, atol=1e-12 * dscale)


def test_kernel_from_reference_carries_parameters():
    kj = 1.2 * jk.ExpSquaredKernel(25.0) + 0.3 * jk.Matern32Kernel(8.0)
    kj.set_parameter_vector(kj.get_parameter_vector() + [0.3, -0.2, 0.1,
                                                         0.4])
    kt = convert.kernel_from_reference(
        1.0 * tk.ExpSquaredKernel(1.0) + 1.0 * tk.Matern32Kernel(1.0),
        kj.get_parameter_names(), kj.get_parameter_vector(),
    )
    x = _points(kt, 9, 7)
    np.testing.assert_allclose(kt.get_value(x, device="cpu"),
                               np.asarray(kj.get_value(x)),
                               rtol=1e-12)
    with pytest.raises(ValueError):
        convert.kernel_from_reference(tk.ExpSquaredKernel(1.0),
                                      kj.get_parameter_names(),
                                      kj.get_parameter_vector())


def test_safe_sqrt_zero_gradient_both_modes():
    r2 = torch.tensor([0.0, 4.0], dtype=torch.float64, requires_grad=True)
    (g,) = torch.autograd.grad(safe_sqrt(r2).sum(), r2)
    assert torch.isfinite(g).all()
    np.testing.assert_allclose(g.numpy(), [0.0, 0.25], rtol=1e-15)

    val, tan = torch.func.jvp(safe_sqrt, (r2.detach(),),
                              (torch.ones(2, dtype=torch.float64),))
    np.testing.assert_allclose(val.numpy(), [0.0, 2.0], rtol=1e-15)
    assert torch.isfinite(tan).all()
    np.testing.assert_allclose(tan.numpy(), [0.0, 0.25], rtol=1e-15)

    # the reference's safe_sqrt has the same derivative at 0
    from george_tpu.kernels.base import safe_sqrt as jax_safe_sqrt

    gj = jax.grad(lambda v: jnp.sum(jax_safe_sqrt(v)))(
        jnp.asarray([0.0, 4.0]))
    np.testing.assert_allclose(g.numpy(), np.asarray(gj), rtol=1e-15)


def test_diagonal_gradient_finite_at_coincident_points():
    """Matern kernels take sqrt(r2): the diagonal's gradient must be
    finite in reverse and forward mode."""
    kt = 1.2 * tk.ExpSquaredKernel(25.0) + 0.3 * tk.Matern32Kernel(8.0)
    x = torch.as_tensor(_points(kt, 6, 1))
    theta = kt.theta.clone().requires_grad_(True)
    K = kt.gram(theta, x, x)
    (g,) = torch.autograd.grad(K.sum(), theta)
    assert torch.isfinite(g).all()
    _, t = torch.func.jvp(lambda th: kt.gram(th, x, x), (kt.theta,),
                          (torch.ones_like(kt.theta),))
    assert torch.isfinite(t).all()


def test_codegen_check_passes():
    proc = subprocess.run(
        [sys.executable, "-m", "george_tpu_torch.kernels.codegen", "--check"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "in sync" in proc.stdout
