# -*- coding: utf-8 -*-
"""The george kernel-evaluation API of the port against the JAX package
(float64, on the CPU): ``get_cutoff``, the CSR ``get_value`` /
``get_gradient`` (``nns=``), ``get_x1_gradient`` / ``get_x2_gradient``,
the ``test_*gradient`` finite-difference checks, ``BasicSolver.get_full``,
``metric_param_count``, ``check_gradient``, ``assemble_dense``, the
device every evaluation runs on, and a compact-support kernel with an
amplitude through the sparse solver."""

import inspect

import numpy as np
import pytest
import scipy.sparse
import torch

import jax
import jax.numpy as jnp

import george_tpu as jgt
from george_tpu import metrics as jmetrics
from george_tpu import utils as jutils
from george_tpu.solvers import linalg as jlinalg
import george_tpu_torch as tgt
from george_tpu_torch import metrics as tmetrics
from george_tpu_torch import utils as tutils
from george_tpu_torch.solvers import linalg as tlinalg

jax.config.update("jax_enable_x64", True)

DEV = "cpu"   # the port's entry points default to the card


def _wendland(pkg, amp=None, log_rc=np.log(2.0)):
    k = pkg.kernels.WendlandC2Kernel(
        log_rc=log_rc, kernel_base=pkg.kernels.ExpSquaredKernel(1.0))
    return k if amp is None else amp * k


def _kernels(pkg):
    """Kernels across the API's branches: compact support alone, scaled,
    summed with and multiplied by a kernel without it, 2-D."""
    k = pkg.kernels
    return {
        "wendland": _wendland(pkg),
        "scaled": _wendland(pkg, 2.0),
        "sum": _wendland(pkg, 2.0) + 0.5 * k.Matern32Kernel(1.3),
        "product": k.ExpSine2Kernel(gamma=2.0, log_period=0.3)
        * _wendland(pkg, 1.5),
        "expsq": 1.3 * k.ExpSquaredKernel(0.7),
        "2d": 1.2 * k.Matern52Kernel([1.0, 2.0], ndim=2),
    }


NAMES = list(_kernels(tgt))


def _points(name, n, seed):
    rng = np.random.default_rng(seed)
    if name == "2d":
        return rng.uniform(0, 4, (n, 2))
    return np.sort(rng.uniform(0, 10, n))[:, None]


@pytest.mark.parametrize("name", NAMES)
def test_get_cutoff_matches_reference(name):
    kj, kt = _kernels(jgt)[name], _kernels(tgt)[name]
    assert kt.get_cutoff() == kj.get_cutoff()


def test_get_cutoff_rules():
    """``inf`` on the base class, the max over a ``Sum``, the min over a
    ``Product``."""
    k = tgt.kernels
    assert k.ExpSquaredKernel(1.0).get_cutoff() == np.inf
    w = _wendland(tgt, log_rc=np.log(3.0))
    assert w.get_cutoff() == pytest.approx(3.0)
    assert (2.0 * w).get_cutoff() == pytest.approx(3.0)
    assert (w + k.ExpSquaredKernel(1.0)).get_cutoff() == np.inf
    assert (w + _wendland(tgt, log_rc=np.log(5.0))).get_cutoff() == (
        pytest.approx(5.0))
    assert (w * _wendland(tgt, log_rc=np.log(5.0))).get_cutoff() == (
        pytest.approx(3.0))


@pytest.mark.parametrize("name", ["wendland", "scaled", "product"])
def test_sparse_value_and_gradient_match_reference(name):
    """``get_value(x, nns=True)`` and ``get_gradient(x, nns=True)``: CSR
    matrices over the radius neighbours, against the JAX package's, and
    the sparse value against the dense one on its pattern."""
    kj, kt = _kernels(jgt)[name], _kernels(tgt)[name]
    x = _points(name, 60, 1)
    Vj = kj.get_value(x, nns=True)
    Vt = kt.get_value(x, nns=True, device=DEV)
    assert isinstance(Vt, scipy.sparse.csr_matrix) and Vt.shape == (60, 60)
    assert Vt.nnz == Vj.nnz and 60 < Vt.nnz < 60 * 60
    np.testing.assert_array_equal(Vt.indices, Vj.indices)
    np.testing.assert_array_equal(Vt.indptr, Vj.indptr)
    np.testing.assert_allclose(Vt.data, Vj.data, rtol=0, atol=1e-12)
    np.testing.assert_allclose(Vt.toarray(), kt.get_value(x, device=DEV),
                               rtol=0, atol=1e-12)
    Gj = kj.get_gradient(x, nns=True)
    Gt = kt.get_gradient(x, nns=True, device=DEV)
    assert len(Gt) == len(Gj) == len(kt.get_parameter_names())
    for a, b in zip(Gt, Gj):
        assert isinstance(a, scipy.sparse.csr_matrix)
        np.testing.assert_allclose(a.toarray(), b.toarray(), rtol=0,
                                   atol=1e-12)


def test_sparse_value_takes_neighbour_structures():
    """``nns`` as a CSR pair, a ragged listing (``neighbors_to_csr``) and a
    kNN matrix (its symmetrized union pattern), as the JAX package."""
    from george_tpu_torch.neighbors import knn_indices, radius_neighbors_csr

    kj, kt = _wendland(jgt, 2.0), _wendland(tgt, 2.0)
    x = _points("scaled", 50, 2)
    csr = radius_neighbors_csr(x, 1.0)
    ragged = np.empty(50, dtype=object)     # e.g. query_radius's output
    ragged[:] = [csr[0][csr[1][i]:csr[1][i + 1]] for i in range(50)]
    knn = knn_indices(x, 5)
    for nns in (csr, ragged, knn):
        Vj = kj.get_value(x, nns=nns)
        Vt = kt.get_value(x, nns=nns, device=DEV)
        np.testing.assert_array_equal(Vt.indptr, Vj.indptr)
        np.testing.assert_allclose(Vt.toarray(), Vj.toarray(), rtol=0,
                                   atol=1e-12)
    flat, ptr = kt.neighbors_to_csr(ragged)
    np.testing.assert_array_equal(flat, csr[0])
    np.testing.assert_array_equal(ptr, csr[1])
    assert kt.nns_saved is not None


@pytest.mark.parametrize("name", NAMES)
def test_input_gradients_match_reference(name):
    kj, kt = _kernels(jgt)[name], _kernels(tgt)[name]
    x1, x2 = _points(name, 9, 3), _points(name, 7, 4)
    for args in ((x1,), (x1, x2)):
        for which in ("get_x1_gradient", "get_x2_gradient"):
            gj = np.asarray(getattr(kj, which)(*args))
            gt = getattr(kt, which)(*args, device=DEV)
            assert gt.shape == gj.shape == (
                len(x1), len(args[-1]), x1.shape[1])
            np.testing.assert_allclose(gt, gj, rtol=0, atol=1e-10)


@pytest.mark.parametrize("name", ["expsq", "sum", "2d"])
def test_finite_difference_checks_agree(name):
    """The ``test_*gradient`` checks pass where the JAX package's pass, and
    both fail on a deliberately wrong analytic gradient."""
    kj, kt = _kernels(jgt)[name], _kernels(tgt)[name]
    x1, x2 = _points(name, 5, 5), _points(name, 4, 6)
    kj.test_gradient(x1)
    kt.test_gradient(x1, device=DEV)
    for k, kw in ((kj, {}), (kt, {"device": DEV})):
        k.test_x1_gradient(x1.copy(), **kw)
        k.test_x2_gradient(x1.copy(), x2.copy(), **kw)
    wrong = type(kt).get_gradient

    def doubled(self, *a, **kw):
        return 2.0 * wrong(self, *a, **kw)

    kt.get_gradient = doubled.__get__(kt)
    with pytest.raises(AssertionError):
        kt.test_gradient(x1, device=DEV)


def test_evaluation_defaults_to_the_card():
    """Every evaluation method takes ``device=`` and defaults to the card;
    none picks a device itself."""
    k = tgt.kernels.ExpSquaredKernel(1.0)
    for name in ("get_value", "get_gradient", "get_x1_gradient",
                 "get_x2_gradient", "test_gradient", "test_x1_gradient",
                 "test_x2_gradient"):
        param = inspect.signature(getattr(k, name)).parameters["device"]
        assert param.default == "cuda", name
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            k.get_value(np.zeros((2, 1)))


def test_gp_get_matrix_uses_its_device(monkeypatch):
    gp = tgt.GP(1.0 * tgt.kernels.ExpSquaredKernel(1.0), device=DEV)
    seen = []
    original = type(gp.kernel).get_value

    def spy(self, *a, **kw):
        seen.append(kw.get("device"))
        return original(self, *a, **kw)

    monkeypatch.setattr(type(gp.kernel), "get_value", spy)
    x = _points("expsq", 6, 7)
    K = gp.get_matrix(x)
    assert K.shape == (6, 6) and seen == [gp.device]
    gp.get_matrix(x, x[:3])
    assert seen[-1] == gp.device


def test_basic_solver_get_full_matches_reference():
    kj, kt = _kernels(jgt)["sum"], _kernels(tgt)["sum"]
    x = _points("sum", 30, 8)
    yerr = 0.1 + 0.05 * np.random.default_rng(8).random(30)
    sj = jgt.BasicSolver(kj)
    st = tgt.BasicSolver(kt, device=DEV)
    sj.compute(x, yerr)
    st.compute(x, yerr)
    for i in range(len(kt.get_parameter_vector()) + 1):
        np.testing.assert_allclose(st.get_full(i), np.asarray(sj.get_full(i)),
                                   rtol=0, atol=1e-12)


@pytest.mark.parametrize("metric_type,naxes", [(0, 1), (0, 3), (1, 2),
                                               (1, 4), (2, 1), (2, 3)])
def test_metric_param_count_matches_reference(metric_type, naxes):
    assert tmetrics.metric_param_count(metric_type, naxes) == (
        jmetrics.metric_param_count(metric_type, naxes))


def test_metric_param_count_refuses_unknown_type():
    with pytest.raises(ValueError):
        tmetrics.metric_param_count(3, 2)


def test_check_gradient_passes_and_fails_as_reference():
    """``utils.check_gradient`` on a GP's likelihood (the george idiom),
    and on a model whose gradient is wrong."""
    x = _points("expsq", 40, 9)[:, 0]
    y = np.sin(x)
    for pkg, utils, kw in ((jgt, jutils, {}), (tgt, tutils,
                                               {"device": DEV})):
        gp = pkg.GP(1.3 * pkg.kernels.ExpSquaredKernel(0.7), **kw)
        gp.compute(x, 0.1)
        utils.check_gradient(gp, y, eps=1e-6)

    class Wrong(object):
        def __init__(self):
            self.v = np.array([0.3, -0.2])

        def get_parameter_vector(self):
            return self.v.copy()

        def set_parameter_vector(self, v):
            self.v = np.array(v)

        def get_parameter_names(self):
            return ["a", "b"]

        def get_value(self):
            return float(np.sum(self.v ** 2))

        def get_gradient(self):
            return 3.0 * self.v

    for utils in (jutils, tutils):
        with pytest.raises(AssertionError):
            utils.check_gradient(Wrong())


def test_assemble_dense_matches_reference():
    kj, kt = _kernels(jgt)["2d"], _kernels(tgt)["2d"]
    x1, x2 = _points("2d", 11, 10), _points("2d", 6, 11)
    theta = kt.get_parameter_vector(include_frozen=True)
    Kj = np.asarray(jlinalg.assemble_dense(kj.pair_fn, jnp.asarray(theta),
                                           jnp.asarray(x1), jnp.asarray(x2)))
    Kt = tlinalg.assemble_dense(kt.pair_fn, torch.as_tensor(theta),
                                torch.as_tensor(x1), torch.as_tensor(x2))
    assert Kt.shape == (11, 6)
    np.testing.assert_allclose(Kt.numpy(), Kj, rtol=0, atol=1e-13)
    assert "assemble_dense" in tlinalg.__all__


# the JAX package's likelihood of sin(x) under 2.0 * WendlandC2(cutoff 2,
# ExpSquared(1) base) on the points below, yerr 0.1, in float64 (with x64
# off it computes in float32 and returns 48.938146192467855)
SCALED_WENDLAND_LL = 48.93813607091002


@pytest.mark.parametrize("direct", ["auto", False])
def test_scaled_compact_support_through_the_sparse_solver(direct):
    """An amplitude times a compact-support kernel (a ``Product``) through
    ``SparseSolver``: n = 300 sorted points on [0, 50] (``default_rng(0)``),
    cutoff 2, yerr 0.1. The exact banded path holds the JAX package's
    float64 likelihood to 1e-10; the iterative one, on the JAX package's
    probes, its own iterative value to 1e-8."""
    n = 300
    x = np.sort(np.random.default_rng(0).uniform(0, 50, n))
    y = np.sin(x)
    gj = jgt.GP(_wendland(jgt, 2.0), solver=jgt.SparseSolver, direct=direct)
    gj.compute(x, 0.1)
    lj = gj.log_likelihood(y)
    kw = {}
    if direct is False:
        kw = {name: np.array(jax.random.rademacher(
            jax.random.PRNGKey(s), (16, n), dtype=jnp.float64))
            for name, s in (("probes", 42), ("grad_probes", 43))}
    gt = tgt.GP(_wendland(tgt, 2.0), solver=tgt.SparseSolver, device=DEV,
                direct=direct, **kw)
    gt.compute(x, 0.1)
    lt = gt.log_likelihood(y)
    if direct == "auto":
        assert gt.solver._band_factors is not None
        assert abs(lj - SCALED_WENDLAND_LL) < 1e-10
        assert abs(lt - SCALED_WENDLAND_LL) < 1e-10
    else:
        assert abs(lt - lj) < 1e-8 * abs(lj)
    np.testing.assert_allclose(gt.grad_log_likelihood(y),
                               gj.grad_log_likelihood(y), rtol=1e-8,
                               atol=1e-10)
