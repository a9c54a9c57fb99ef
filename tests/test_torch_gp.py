# -*- coding: utf-8 -*-
"""The port's ``GP`` object held against the JAX package's, in float64 on
the CPU, on the scaling tutorial's dataset (``tests/test_golden.py``).

``BasicSolver`` is the same dense computation in both packages and is held
to 1e-10 (likelihood) and 1e-8 (gradient, prediction). ``HODLRSolver`` at
rank 48 compresses far past the kernel's numerical rank, so the ACA walk's
last slots are ties among rounding noise and the two packages' pivots may
differ there; the comparison therefore hands the JAX solver's pivots to
the port. The likelihood then agrees to 1e-10. Its exact gradient goes
through the ridge-regularized skeleton solves at their ridge floor
(cond ~ 5e14), whose derivative amplifies summation-order differences:
measured 1.4e-6, held to 5e-6 (the JAX package's own layout-parity test
holds its gradients to 1e-4).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import george_tpu as jgt
from george_tpu.solvers import HODLRSolver as JaxHODLR
import george_tpu_torch as tgt
from george_tpu_torch.solvers import hodlr as TH

torch.set_num_threads(2)

REF_LL = 133.946394912
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEV = "cpu"   # the port's entry points default to the card


def _scaling_dataset():
    np.random.seed(1234)
    x = np.sort(np.random.uniform(0, 10, 50000))
    yerr = 0.1 * np.ones_like(x)
    y = np.sin(x)
    return x, y, yerr


X, Y, YERR = _scaling_dataset()
T_PRED = np.linspace(0.05, 9.95, 23)


def _kernel(pkg):
    return np.var(Y) * pkg.kernels.ExpSquaredKernel(1.0)


def _assert_predict(gj, gt, n, rtol):
    mj, vj = gj.predict(Y[:n], T_PRED, return_var=True)
    mt, vt = gt.predict(Y[:n], T_PRED, return_var=True)
    assert mt.shape == mj.shape and vt.shape == vj.shape
    np.testing.assert_allclose(mt, mj, rtol=rtol, atol=rtol * np.abs(mj).max())
    np.testing.assert_allclose(vt, vj, rtol=rtol, atol=rtol * np.abs(vj).max())


def test_basic_gp_matches_reference():
    n = 1000
    gj = jgt.GP(_kernel(jgt))
    gt = tgt.GP(_kernel(tgt), device=DEV)
    for gp in (gj, gt):
        gp.compute(X[:n], YERR[:n])
    lj, lt = gj.log_likelihood(Y[:n]), gt.log_likelihood(Y[:n])
    assert abs(lt - lj) / abs(lj) < 1e-10
    np.testing.assert_allclose(gt.grad_log_likelihood(Y[:n]),
                               gj.grad_log_likelihood(Y[:n]), rtol=1e-8)
    _assert_predict(gj, gt, n, 1e-8)


def _hodlr_pair(monkeypatch, n, **kw):
    """JAX and port GPs with HODLRSolver(**kw), computed on the first n
    points, the port taking the JAX solver's pivots."""
    gj = jgt.GP(_kernel(jgt), solver=JaxHODLR, **kw)
    gj.compute(X[:n], YERR[:n])
    ref = gj.solver._struct

    def jax_pivots(pair_fn, theta, xpad, valid, struct):
        for mine, theirs in zip(struct.levels, ref.levels):
            mine["row_piv"] = np.asarray(theirs["row_piv"])
            mine["col_piv"] = np.asarray(theirs["col_piv"])
        struct._build_flat()

    monkeypatch.setattr(TH, "select_aca_pivots", jax_pivots)
    gt = tgt.GP(_kernel(tgt), solver=tgt.HODLRSolver, device=DEV, **kw)
    gt.compute(X[:n], YERR[:n])
    assert gt.solver._struct.L == ref.L >= 3
    return gj, gt


def test_hodlr_gp_matches_reference(monkeypatch):
    n = 2000
    gj, gt = _hodlr_pair(monkeypatch, n, seed=42, min_size=64, rank=48)
    lj, lt = gj.log_likelihood(Y[:n]), gt.log_likelihood(Y[:n])
    assert abs(lt - lj) / abs(lj) < 1e-10
    np.testing.assert_allclose(gt.grad_log_likelihood(Y[:n]),
                               gj.grad_log_likelihood(Y[:n]), rtol=5e-6)
    _assert_predict(gj, gt, n, 1e-8)


def test_hodlr_hutchinson_gradient_matches_reference(monkeypatch):
    """``grad_mode="hutchinson"``: both packages draw the same numpy
    Rademacher probes from the solver's seed, so the matrix-free gradients
    agree like the exact ones."""
    n = 2000
    gj, gt = _hodlr_pair(monkeypatch, n, seed=42, min_size=64, rank=48,
                         grad_mode="hutchinson", num_probes=16)
    assert gt.solver.matrix_free
    lj, lt = gj.log_likelihood(Y[:n]), gt.log_likelihood(Y[:n])
    assert abs(lt - lj) / abs(lj) < 1e-10
    gj_h = gj.grad_log_likelihood(Y[:n])
    gt_h = gt.grad_log_likelihood(Y[:n])
    # measured: every component's error is within 2.8e-6 of the largest
    # component (1.6e-5 relative on the smaller one), hence the atol
    np.testing.assert_allclose(gt_h, gj_h, rtol=1e-5,
                               atol=1e-5 * np.abs(gj_h).max())


def test_hodlr_gp_tracks_exact_with_its_own_pivots():
    """Through the public API alone (the port picks its own ACA pivots),
    the compressed likelihood and gradient track the dense answer."""
    n = 2000
    gh = tgt.GP(_kernel(tgt), solver=tgt.HODLRSolver, seed=42, min_size=64,
                rank=48, device=DEV)
    gb = tgt.GP(_kernel(tgt), device=DEV)
    for gp in (gh, gb):
        gp.compute(X[:n], YERR[:n])
    lb = gb.log_likelihood(Y[:n])
    assert abs(gh.log_likelihood(Y[:n]) - lb) / abs(lb) < 1e-8
    np.testing.assert_allclose(gh.grad_log_likelihood(Y[:n]),
                               gb.grad_log_likelihood(Y[:n]), rtol=1e-4)
    mh, vh = gh.predict(Y[:n], T_PRED, return_var=True)
    mb, vb = gb.predict(Y[:n], T_PRED, return_var=True)
    np.testing.assert_allclose(mh, mb, atol=1e-6)
    np.testing.assert_allclose(vh, vb, atol=1e-6)


@pytest.mark.parametrize("solver", ["basic", "hodlr"])
def test_golden_loglike(solver):
    kw = {"solver": tgt.HODLRSolver, "seed": 42} if solver == "hodlr" else {}
    gp = tgt.GP(_kernel(tgt), device=DEV, **kw)
    gp.compute(X[:100], YERR[:100])
    assert abs(gp.log_likelihood(Y[:100]) - REF_LL) < 1e-7


def test_error_paths():
    x, y, yerr = X[:40], Y[:40], YERR[:40]
    gp = tgt.GP(tgt.kernels.ConstantKernel(log_constant=0.0), device=DEV)
    with pytest.raises(RuntimeError):
        gp.log_likelihood(y)
    gp.compute(x, yerr)
    assert np.isfinite(gp.log_likelihood(y))
    with pytest.raises(ValueError, match="Dimension mismatch"):
        gp.log_likelihood(y[:-1])
    with pytest.raises(ValueError, match="Dimension mismatch"):
        gp.compute(np.ones((40, 2)), yerr)
    # an overflowing amplitude makes the refactorization fail
    gp.compute(x, yerr)
    gp.set_parameter_vector(np.array([800.0]))
    assert gp.log_likelihood(y, quiet=True) == -np.inf
    assert np.all(gp.grad_log_likelihood(y, quiet=True) == 0.0)
    with pytest.raises((ValueError, np.linalg.LinAlgError)):
        gp.log_likelihood(y, quiet=False)


def test_hodlr_solver_refuses_unported_options():
    k = _kernel(tgt)
    for kw in ({"sym": True}, {"mesh": object()}, {"knn": 8},
               {"debug": True}):
        with pytest.raises(NotImplementedError):
            tgt.HODLRSolver(k, device=DEV, **kw)


def test_nll_apply_inverse_and_dtype():
    n = 300
    gp = tgt.GP(_kernel(tgt), solver=tgt.HODLRSolver, min_size=32, rank=24,
                device=DEV)
    gb = tgt.GP(_kernel(tgt), device=DEV)
    for g in (gp, gb):
        g.compute(X[:n], YERR[:n])
    v = gp.get_parameter_vector()
    assert gp.nll(v, Y[:n]) == -gp.log_likelihood(Y[:n])
    np.testing.assert_allclose(gp.grad_nll(v, Y[:n]),
                               -gp.grad_log_likelihood(Y[:n]), rtol=1e-12)
    z, zb = gp.apply_inverse(Y[:n]), gb.apply_inverse(Y[:n])
    assert np.linalg.norm(z - zb) / np.linalg.norm(zb) < 1e-4
    Z = gp.apply_inverse(np.stack([Y[:n], 2 * Y[:n]], axis=1))
    assert Z.shape == (n, 2)
    assert np.linalg.norm(Z[:, 1] - 2 * z) / np.linalg.norm(2 * z) < 1e-8
    # the solver works in the GP's dtype, on its device
    g32 = tgt.GP(_kernel(tgt), solver=tgt.HODLRSolver, min_size=32,
                 rank=24, dtype=torch.float32, device=DEV)
    g32.compute(X[:n], YERR[:n])
    assert g32.solver.dtype == torch.float32
    assert g32.solver._factors["Lleaf"].dtype == torch.float32
    assert g32.solver._factors["Lleaf"].device.type == "cpu"
    assert np.isfinite(g32.log_likelihood(Y[:n]))


def test_import_pulls_in_neither_jax_nor_yaml():
    code = ("import sys, george_tpu_torch; "
            "bad = [m for m in ('jax', 'yaml', 'george_tpu') "
            "if m in sys.modules]; print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _sparse_gp(pkg, n, **kw):
    """A GP on the sparse solver, on sorted 1-D data (the banded path), with
    a fitted mean and white noise so every gradient block is exercised."""
    rng = np.random.default_rng(21)
    x = np.sort(rng.uniform(0, 25, n))
    y = np.sin(x) + 0.1 * rng.standard_normal(n)
    k = pkg.kernels.WendlandC2Kernel(
        log_rc=np.log(1.5), kernel_base=pkg.kernels.ExpSquaredKernel(1.0))
    gp = pkg.GP(k, solver=pkg.SparseSolver, mean=0.1, fit_mean=True,
                white_noise=np.log(0.01), fit_white_noise=True, **kw)
    gp.compute(x, 0.1)
    return gp, y


@pytest.mark.parametrize("direct", ["auto", False])
def test_sparse_gp_matches_reference(direct):
    """``GP(..., solver=SparseSolver)`` against the JAX GP: the exact banded
    direct path (``"auto"``) to 1e-10 (likelihood) and 1e-8 (gradient); the
    iterative path (``False``) with the JAX package's own Rademacher probes
    handed to the port, to 1e-8 (measured <= 1e-11)."""
    import jax
    import jax.numpy as jnp

    n, seed = 400, 42
    gj, y = _sparse_gp(jgt, n, direct=direct, seed=seed)
    kw = {}
    if direct is False:
        kw = {name: np.array(jax.random.rademacher(
            jax.random.PRNGKey(s), (16, n), dtype=jnp.float64))
            for name, s in (("probes", seed), ("grad_probes", seed + 1))}
    gt, _ = _sparse_gp(tgt, n, direct=direct, seed=seed, device=DEV, **kw)
    assert (gt.solver._band_factors is not None) == (direct == "auto")
    assert gt.get_parameter_names() == gj.get_parameter_names()
    lj, lt = gj.log_likelihood(y), gt.log_likelihood(y)
    assert abs(lt - lj) / abs(lj) < (1e-10 if direct == "auto" else 1e-8)
    gradj, gradt = gj.grad_log_likelihood(y), gt.grad_log_likelihood(y)
    assert len(gradt) == 4
    np.testing.assert_allclose(gradt, gradj, rtol=1e-8)


def test_entry_points_default_to_the_card():
    """``GP``, ``BasicSolver``, ``HODLRSolver`` and ``SparseSolver`` default
    to ``device="cuda"`` (read from the attribute; no tensor is made)."""
    k = _kernel(tgt)
    for obj in (tgt.GP(k), tgt.BasicSolver(k), tgt.HODLRSolver(k),
                tgt.SparseSolver(k)):
        assert obj.device == torch.device("cuda")


def test_spec_copy_is_identical():
    """The port generates its kernels from its own copy of the JAX
    package's YAML specs; the two directories must hold the same bytes."""
    from george_tpu_torch.kernels import codegen

    theirs = os.path.join(REPO, "george_tpu", "kernels", "specs")
    assert os.path.samefile(codegen.SPEC_DIR, os.path.join(
        REPO, "george_tpu_torch", "kernels", "specs"))
    names = sorted(os.listdir(theirs))
    assert sorted(os.listdir(codegen.SPEC_DIR)) == names
    for name in names:
        with open(os.path.join(theirs, name), "rb") as a, open(
                os.path.join(codegen.SPEC_DIR, name), "rb") as b:
            assert a.read() == b.read(), name


def test_every_submodule_imports_with_jax_blocked():
    """Every module of the port imports in a process where ``jax``,
    ``george_tpu`` and ``yaml`` cannot be imported at all."""
    code = (
        "import sys, pkgutil, importlib\n"
        "for m in ('jax', 'george_tpu', 'yaml'): sys.modules[m] = None\n"
        "import george_tpu_torch as g\n"
        "names = [m.name for m in pkgutil.walk_packages(g.__path__, "
        "'george_tpu_torch.')]\n"
        "for name in names: importlib.import_module(name)\n"
        "assert 'george_tpu_torch.ops.dia' in names\n"
        "assert 'george_tpu_torch.solvers.sparse' in names\n"
        "print(len(names))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
