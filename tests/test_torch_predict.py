# -*- coding: utf-8 -*-
"""``GP.predict``'s device-side posterior (``GP._posterior``) and the
solvers' ``solve_columns``, in float64 on the CPU.

* Test points taken in several blocks (``gp._PREDICT_BLOCK_BYTES``
  lowered) give the one-block answer: the blocks only split independent
  columns. The dense and banded solves give it to 1e-12. The HODLR
  cascade gives it to 1e-9: its einsums round a column differently with
  the width of the batch (4.5e-14 at one level here), and its SMW cores,
  of condition ~2e6 here, amplify that (measured 1.5e-10 on the variance).
* Each solver's ``solve_columns`` on device columns equals its numpy
  ``apply_inverse`` bit for bit: the same solve on the same padded rows.
* The ``kernel=`` override and a mean model match the JAX package to 1e-8,
  in one block and in several.
"""

import numpy as np
import pytest
import torch

import george_tpu as jgt
import george_tpu_torch as tgt
from george_tpu_torch import gp as TGP

DEV = "cpu"
N = 400
T_PRED = np.linspace(0.05, 9.95, 37)


def _data(n=N, dim=1, seed=5):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 10, (n, dim))
    x = np.sort(x[:, 0]) if dim == 1 else x
    f = np.sin(x) if dim == 1 else np.sin(x[:, 0]) * np.cos(x[:, 1])
    return x, f + 0.1 * rng.standard_normal(n)


def _gp(solver, x):
    """A computed float64 GP on the CPU through ``solver``."""
    k = tgt.kernels
    if solver == "trivial":
        gp = tgt.GP(device=DEV)
    elif solver in ("sparse", "sparse_cg"):
        kern = k.WendlandC2Kernel(log_rc=np.log(1.5),
                                  kernel_base=k.ExpSquaredKernel(1.0))
        gp = tgt.GP(kern, solver=tgt.SparseSolver, device=DEV,
                    direct="auto" if solver == "sparse" else False)
    else:
        kern = 0.8 * k.ExpSquaredKernel(
            1.2, ndim=1 if np.ndim(x) == 1 else x.shape[1])
        kw = {"dense": {},
              "hodlr": {"solver": tgt.HODLRSolver, "min_size": 32,
                        "rank": 24},
              "hmatrix": {"solver": tgt.HMatrixSolver, "min_size": 32,
                          "rank": 12}}[solver]
        gp = tgt.GP(kern, device=DEV, **kw)
    gp.compute(x, 0.1)
    return gp


@pytest.mark.parametrize("out", ["var", "cov"])
@pytest.mark.parametrize("solver", ["dense", "hodlr", "sparse"])
def test_blocked_posterior_equals_one_block(monkeypatch, solver, out):
    """With the block budget lowered to 10 test points, 37 points go
    through in 4 blocks and give the one-block mean, variance and
    covariance (to 1e-12; HODLR to 1e-9, see the module docstring)."""
    x, y = _data()
    gp = _gp(solver, x)
    kw = {"return_var": True} if out == "var" else {}
    assert len(TGP._blocks(len(T_PRED), N)) == 1
    mu1, s1 = gp.predict(y, T_PRED, **kw)
    monkeypatch.setattr(TGP, "_PREDICT_BLOCK_BYTES", 8 * N * 10)
    assert len(TGP._blocks(len(T_PRED), N)) == 4
    mu4, s4 = gp.predict(y, T_PRED, **kw)
    assert s4.shape == s1.shape == ((37,) if out == "var" else (37, 37))
    tol = 1e-9 if solver == "hodlr" else 1e-12
    for a, b in ((mu4, mu1), (s4, s1)):
        np.testing.assert_allclose(a, b, rtol=0, atol=tol * np.abs(b).max())


@pytest.mark.parametrize("solver", ["trivial", "dense", "hodlr", "hmatrix",
                                    "sparse", "sparse_cg"])
def test_solve_columns_equals_apply_inverse(solver):
    """``solve_columns`` on device columns in the original point order is
    the numpy ``apply_inverse`` of the same columns, bit for bit, and
    returns a tensor on the solver's device."""
    x, _ = _data(dim=2 if solver == "hmatrix" else 1)
    gp = _gp(solver, x)
    R = np.random.default_rng(8).standard_normal((N, 7))
    Z = gp.solver.solve_columns(torch.as_tensor(R, device=DEV))
    assert isinstance(Z, torch.Tensor) and Z.shape == (N, 7)
    np.testing.assert_array_equal(Z.numpy(), gp.solver.apply_inverse(R))


def _mixture(pkg):
    k = pkg.kernels
    return (0.8 * k.ExpSquaredKernel(1.2), 0.3 * k.Matern32Kernel(0.5))


@pytest.mark.parametrize("blocks", [1, 4])
def test_kernel_override_and_mean_model_match_reference(monkeypatch, blocks):
    """A GP with a constant mean model and a sum kernel: the mean of each
    component (``kernel=``) and the whole posterior against the JAX GP, to
    1e-8."""
    if blocks > 1:
        monkeypatch.setattr(TGP, "_PREDICT_BLOCK_BYTES", 8 * N * 10)
    assert len(TGP._blocks(len(T_PRED), N)) == blocks
    x, y = _data()
    out = []
    for pkg, kw in ((jgt, {}), (tgt, {"device": DEV})):
        k1, k2 = _mixture(pkg)
        gp = pkg.GP(k1 + k2, mean=0.7, **kw)
        gp.compute(x, 0.1)
        out.append([gp.predict(y, T_PRED, return_cov=False, kernel=k)
                    for k in _mixture(pkg)]
                   + list(gp.predict(y, T_PRED, return_var=True))
                   + [gp.predict(y, T_PRED)[1]])
    for mine, ref in zip(out[1], out[0]):
        ref = np.asarray(ref)
        np.testing.assert_allclose(mine, ref, rtol=1e-8,
                                   atol=1e-8 * np.abs(ref).max())
