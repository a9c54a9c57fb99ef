"""The plain reference against dense float64 numpy at small sizes."""

import json
import os

import numpy as np
import pytest
import torch

from gpbench.reference import gp as rgp
from gpbench.reference import kernel

from .conftest import ROOT


def _config(name):
    with open(os.path.join(ROOT, "gpbench", "configs", name + ".json")) as f:
        return json.load(f)


def smooth_k(theta, d):
    c1, m1, c2, m2 = np.exp(theta)
    r = np.sqrt(3.0 * d * d / m2)
    return c1 * np.exp(-0.5 * d * d / m1) + c2 * (1.0 + r) * np.exp(-r)


def wendland_k(theta, d):
    rc, m = np.exp(theta)
    u = np.abs(d) / rc
    taper = np.where(u < 1, (1 - np.minimum(u, 1)) ** 4 * (4 * u + 1), 0.0)
    return taper * np.exp(-0.5 * d * d / m)


def dense_ll(k, theta, x, y, diag):
    K = k(theta, x[:, None] - x[None, :]) + np.diag(diag)
    L = np.linalg.cholesky(K)
    z = np.linalg.solve(L, y)
    return -0.5 * (z @ z + 2 * np.sum(np.log(np.diag(L)))
                   + len(x) * np.log(2 * np.pi))


def fd_grad(f, theta, h=1e-5):
    return np.array([(f(theta + h * e) - f(theta - h * e)) / (2 * h)
                     for e in np.eye(len(theta))])


def data(n, high, seed=3):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0, high, n))
    return x, np.sin(0.1 * x) + 0.3 * rng.standard_normal(n)


@pytest.mark.parametrize("name,k,n,high", [
    ("hodlr_smooth_1e5", smooth_k, 1200, 300.0),
    ("sparse_dia_2e5", wendland_k, 500, 10.0),
])
def test_loglike_and_grad_match_dense(name, k, n, high):
    cfg = _config(name)
    node = kernel.build(cfg["kernel"])
    x, y = data(n, high)
    diag = np.full(n, 0.09)
    theta = np.array(node.theta0) + 0.02
    ref = rgp.BandedGP(node, x, diag, "cpu", min_block=32)
    assert ref.layout(theta)[1] > 2          # several blocks
    v, g = ref.loglike_and_grad(theta, y)
    f = lambda th: dense_ll(k, th, x, y, diag)  # noqa: E731
    assert abs(v - f(theta)) <= 1e-10 * abs(f(theta))
    gd = fd_grad(f, theta)
    assert np.max(np.abs(g - gd)) <= 1e-6 * np.max(np.abs(gd))


def test_predict_matches_dense():
    node = kernel.build(_config("hodlr_smooth_1e5")["kernel"])
    x, y = data(900, 250.0)
    diag = np.full(len(x), 0.09)
    theta = np.array(node.theta0)
    t = np.random.default_rng(5).uniform(0, 250.0, 40)
    mu, var = rgp.BandedGP(node, x, diag, "cpu", min_block=32).predictor(
        theta, y)(t)
    K = smooth_k(theta, x[:, None] - x[None, :]) + np.diag(diag)
    Ks = smooth_k(theta, t[:, None] - x[None, :])
    assert np.allclose(mu, Ks @ np.linalg.solve(K, y), rtol=0, atol=1e-10)
    vd = 1.5 - np.sum(Ks * np.linalg.solve(K, Ks.T).T, axis=1)
    assert np.max(np.abs(var - vd)) <= 1e-9 * np.max(np.abs(vd))


def test_slq_estimator_matches_dense():
    """With as many Lanczos steps as points, the quadrature is the
    Hutchinson estimate of ``tr log K`` over the probes; the gradient is
    the exact quadratic term's and the probes' estimate of the trace."""
    cfg = _config("sparse_dia_2e5")
    node = kernel.build(cfg["kernel"])
    n = 60
    x, y = data(n, 3.0)
    diag = np.full(n, 0.01)
    theta = np.array(node.theta0) + 0.05
    probes = np.where(np.random.default_rng(2).random((4, n)) < 0.5,
                      -1.0, 1.0)
    v, g = rgp.BandedGP(node, x, diag, "cpu", min_block=16) \
        .slq_loglike_and_grad(theta, y, probes, n)

    def K(th):
        return wendland_k(th, x[:, None] - x[None, :]) + np.diag(diag)

    w, U = np.linalg.eigh(K(theta))
    logK = (U * np.log(w)) @ U.T
    est = n * np.mean([p @ logK @ p / (p @ p) for p in probes])
    quad = y @ np.linalg.solve(K(theta), y)
    assert abs(v + 0.5 * (quad + est + n * np.log(2 * np.pi))) <= 1e-9 * abs(v)
    a = np.linalg.solve(K(theta), y)
    W = np.linalg.solve(K(theta), probes.T)
    gd = []
    for e in np.eye(len(theta)):
        dK = (K(theta + 1e-6 * e) - K(theta - 1e-6 * e)) / 2e-6
        gd.append(0.5 * a @ dK @ a - 0.5 * np.mean(
            [W[:, j] @ dK @ probes[j] for j in range(len(probes))]))
    assert np.max(np.abs(g - np.array(gd))) <= 1e-6 * np.max(np.abs(gd))


def test_parameter_names_are_the_programs():
    """The reference's parameter vector means what the program's does."""
    from gpbench import program
    for name in ("hodlr_smooth_1e5", "sparse_dia_2e5"):
        cfg = _config(name)
        node = kernel.build(cfg["kernel"])
        k = program.build_kernel(cfg["kernel"])
        assert list(k.get_parameter_names(include_frozen=True)) == node.names
        assert np.allclose(k.get_parameter_vector(include_frozen=True),
                           node.theta0, rtol=0, atol=1e-12)
        gp = program.build_gp(cfg, "cpu")
        active = [nm for nm in node.names if nm not in cfg["frozen"]]
        assert list(gp.get_parameter_names()) == ["kernel:" + nm
                                                  for nm in active]


def test_tf32_rounding():
    t = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10 + 2.0 ** -12,
                      -3.0 - 2.0 ** -9, 1.0 + 2 ** -12])
    r = rgp.round_tf32(t)
    assert r.tolist() == [1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10,
                          -3.0 - 2.0 ** -9, 1.0]
    a = torch.randn(50, 50)
    rel = (rgp.round_tf32(a) - a).abs() / a.abs()
    assert float(rel.max()) <= 2.0 ** -11
