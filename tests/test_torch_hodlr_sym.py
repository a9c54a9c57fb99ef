# -*- coding: utf-8 -*-
"""The port's symmetric HODLR factorization ``K = W W^T`` (``apply_sqrt``,
``sym=True``, the ``W^{-1}`` / ``W^{-T}`` surface, the symmetric
Hutchinson gradient, ``GP.sample``) and its kNN-guided pivots, held
against the JAX package in float64 on the CPU and against dense oracles.

Tolerances. ``W`` is unique given the skeletons (the QR and eigenvector
signs cancel in ``Qhat M Qhat^T``), so the products ``W X``, ``W^T X``,
``W^{-1} X`` and ``W^{-T} X`` are compared, never the raw factors. On one
shared set of factors the two packages' cascades agree to rounding (held
to 1e-12). Through each package's own skeletons they inherit the ridge
floor of the interpolation solves (see ``tests/test_torch_hodlr.py``):
measured 3e-10 to 8.5e-10 on the n = 600 rig at ranks 16 and 32, held to
5e-9; the log-determinant, which that perturbation does not move at first
order, to 1e-9. The dense-oracle bounds are the JAX package's own
(``tests/test_hodlr.py``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import george_tpu as jgt
from george_tpu import kernels as jk
from george_tpu.neighbors import knn_indices as jax_knn
from george_tpu.solvers import hodlr as JH
import george_tpu_torch as tgt
from george_tpu_torch import convert
from george_tpu_torch import kernels as tk
from george_tpu_torch import neighbors as tn
from george_tpu_torch.solvers import hodlr as TH

torch.set_num_threads(2)

DEV = "cpu"   # the port's entry points default to the card
SHARED = 1e-12
SKELETON = 5e-9


def _t(a):
    return torch.as_tensor(np.array(a))


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(a))


def _data(n, seed=0, span=20.0):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0, span, n))[:, None]
    yerr = 0.3 * np.ones(n)
    y = np.sin(x[:, 0]) + 0.3 * rng.standard_normal(n)
    return x, y, yerr


def _dense(kernel, x, yerr):
    K = kernel.get_value(x, device=DEV)
    K[np.diag_indices_from(K)] += yerr ** 2
    return K


def _gp_pair(monkeypatch, pkg_kernel, x, yerr, **kw):
    """A JAX and a port GP with ``HODLRSolver(**kw)`` computed on ``x``,
    the port taking the JAX solver's ACA pivots."""
    gj = jgt.GP(pkg_kernel(jk), solver=JH.HODLRSolver, **kw)
    gj.compute(x, yerr)
    ref = gj.solver._struct

    def jax_pivots(pair_fn, theta, xpad, valid, struct):
        for mine, theirs in zip(struct.levels, ref.levels):
            mine["row_piv"] = np.asarray(theirs["row_piv"])
            mine["col_piv"] = np.asarray(theirs["col_piv"])
        struct._build_flat()

    monkeypatch.setattr(TH, "select_aca_pivots", jax_pivots)
    gt = tgt.GP(pkg_kernel(tk), solver=tgt.HODLRSolver, device=DEV, **kw)
    gt.compute(x, yerr)
    return gj, gt


# ---------------------------------------------------------------------------
# the factorization against the JAX function, on shared pivots
# ---------------------------------------------------------------------------

class SymRig(object):
    """The n = 600 ExpSquared rig of ``tests/test_torch_hodlr.py`` (3
    levels) with the JAX structure's ACA pivots transplanted into the
    port, and both packages' symmetric factors."""

    def __init__(self, rank):
        rng = np.random.default_rng(11)
        n, ms = 600, 64
        x = np.sort(rng.uniform(0, 40.0, n))[:, None]
        kj = 1.1 * jk.ExpSquaredKernel(2.0)
        kt = 1.1 * tk.ExpSquaredKernel(2.0)
        theta = np.asarray(kj.parameter_vector)
        st = JH.build_structure(n, min_size=ms, rank=rank, seed=42,
                                x_sorted=x)
        xpad = np.concatenate([x, np.repeat(x[-1:], st.n_pad - n, 0)])
        valid = np.zeros(st.n_pad, bool)
        valid[:n] = True
        JH.select_aca_pivots(kj.pair_fn, theta, xpad, valid, st)
        self.st = st
        self.stt = convert.structure_from_arrays(
            n, ms, rank, 42,
            [(lev["row_piv"], lev["col_piv"]) for lev in st.levels])
        dp = np.ones(st.n_pad)
        dp[:n] = 1.0
        pair = kj.pair_fn
        self.fj, self.ldj = jax.jit(
            lambda *a: JH.hodlr_factor_sym(pair, *a, st)
        )(jnp.asarray(theta), jnp.asarray(xpad), jnp.asarray(valid),
          jnp.asarray(dp))
        self.targs = (kt.pair_fn, _t(theta), _t(xpad), _t(valid), _t(dp))
        self.ft, self.ldt = TH.hodlr_factor_sym(*self.targs, self.stt)
        # the JAX factors in the port's row layout: Qu, Qv (p, s, c) ->
        # Qt (c, n_pad), Qu on each pair's left rows and Qv on its right
        self.fs = {"Lleaf": _t(self.fj["Lleaf"]),
                   "levels": [(torch.stack([_t(Qu), _t(Qv)], dim=1).permute(
                       3, 0, 1, 2).reshape(Qu.shape[2], st.n_pad), _t(M),
                       _t(Mi))
                       for Qu, Qv, M, Mi in self.fj["levels"]]}
        self.X = rng.standard_normal((st.n_pad, 3))
        self.x, self.rank = x, rank


_SYM_RIGS = {}


@pytest.fixture(params=[16, 32], ids=["rank16", "rank32"])
def sym_rig(request):
    if request.param not in _SYM_RIGS:
        _SYM_RIGS[request.param] = SymRig(request.param)
    return _SYM_RIGS[request.param]


def test_sym_logdet_matches_reference(sym_rig):
    r = sym_rig
    assert r.stt.L == r.st.L == 3
    assert abs(float(r.ldt) - float(r.ldj)) / abs(float(r.ldj)) < 1e-9


@pytest.mark.parametrize("solve", [False, True], ids=["W", "Winv"])
@pytest.mark.parametrize("transpose", [False, True], ids=["", "T"])
def test_sym_products_match_reference(sym_rig, solve, transpose):
    r = sym_rig
    jfn = JH.hodlr_sqrt_solve if solve else JH.hodlr_sqrt_matvec
    tfn = TH.hodlr_sqrt_solve if solve else TH.hodlr_sqrt_matvec
    want = np.asarray(jfn(r.fj, r.st, jnp.asarray(r.X), transpose=transpose))
    # the port's cascade on the JAX package's factors: rounding only
    assert _rel(want, tfn(r.fs, r.stt, _t(r.X), transpose=transpose)) < (
        SHARED)
    # end to end through the port's own factorization
    got = tfn(r.ft, r.stt, _t(r.X), transpose=transpose)
    assert got.shape == want.shape
    assert _rel(want, got) < SKELETON
    one = tfn(r.ft, r.stt, _t(r.X[:, 0]), transpose=transpose)
    assert one.shape == (r.stt.n_pad,)
    assert _rel(want[:, 0], one) < SKELETON


def test_sym_factor_is_the_compressed_operator(sym_rig):
    """``W W^T`` rebuilds the same compressed operator as the SMW factors
    (``hodlr_matvec_factors``), and ``W^{-T} W^{-1}`` is its inverse."""
    r = sym_rig
    X = _t(r.X)
    f, _ = TH.hodlr_factor(*r.targs, r.stt)
    KX = TH.hodlr_matvec_factors(f, r.stt, X)
    WWtX = TH.hodlr_sqrt_matvec(
        r.ft, r.stt, TH.hodlr_sqrt_matvec(r.ft, r.stt, X, transpose=True))
    assert _rel(KX, WWtX) < 1e-12
    Z = TH.hodlr_sqrt_solve(r.ft, r.stt, TH.hodlr_sqrt_solve(r.ft, r.stt, KX),
                            transpose=True)
    assert _rel(X, Z) < 1e-10


# ---------------------------------------------------------------------------
# the solver surface against dense oracles (bounds of tests/test_hodlr.py)
# ---------------------------------------------------------------------------

def test_port_apply_sqrt_reproduces_dense_kernel():
    x, y, yerr = _data(500)
    kernel = 1.2 * tk.ExpSquaredKernel(2.0)
    K = _dense(kernel, x, yerr)
    s = tgt.HODLRSolver(kernel, min_size=64, rank=48, device=DEV)
    s.compute(x, yerr)
    Wt = s.apply_sqrt(np.eye(len(x)))          # (W I)^T = W^T
    assert np.linalg.norm(Wt.T @ Wt - K) / np.linalg.norm(K) < 1e-5
    # one row in, one row out
    r = np.random.default_rng(3).standard_normal(len(x))
    np.testing.assert_allclose(s.apply_sqrt(r), Wt.T @ r, rtol=1e-10,
                               atol=1e-12)


def test_port_sym_solver_vs_dense():
    x, y, yerr = _data(500)
    kernel = 1.2 * tk.ExpSquaredKernel(2.0)
    K = _dense(kernel, x, yerr)
    _, ld_true = np.linalg.slogdet(K)
    alpha_true = np.linalg.solve(K, y)
    s = tgt.HODLRSolver(kernel, min_size=64, rank=48, sym=True, device=DEV)
    s.compute(x, yerr)
    assert s.sym and s._sym_factors is s._factors
    assert abs(s.log_determinant - ld_true) < 1e-4
    a = s.apply_inverse(y)
    assert np.linalg.norm(a - alpha_true) / np.linalg.norm(alpha_true) < 1e-5
    assert np.isclose(s.dot_solve(y), y @ alpha_true, rtol=1e-6)
    # the symmetric and the SMW cascades factor the same operator
    s2 = tgt.HODLRSolver(kernel, min_size=64, rank=48, device=DEV)
    s2.compute(x, yerr)
    assert abs(s.log_determinant - s2.log_determinant) < 1e-9 * abs(
        s2.log_determinant)
    # refinement wraps the symmetric cascade as well
    s3 = tgt.HODLRSolver(kernel, min_size=64, rank=48, sym=True,
                         refine_steps=1, device=DEV)
    s3.compute(x, yerr)
    a3 = s3.apply_inverse(y)
    assert np.linalg.norm(a3 - alpha_true) / np.linalg.norm(
        alpha_true) < 1e-5


def test_port_sym_W_roundtrips():
    x, y, yerr = _data(400)
    kernel = 1.0 * tk.ExpSquaredKernel(1.5)
    K = _dense(kernel, x, yerr)
    s = tgt.HODLRSolver(kernel, min_size=64, rank=48, sym=True, device=DEV)
    s.compute(x, yerr)
    V = np.random.default_rng(7).standard_normal((len(x), 3))
    # np.allclose: the JAX test's bounds (rtol 1e-5 with these atols)
    WV = s._apply_sym_W(V, solve=False, transpose=False)
    assert np.allclose(s.apply_inverse_sym_W(WV), V, atol=1e-8)
    WtV = s._apply_sym_W(V, solve=False, transpose=True)
    assert np.allclose(s.apply_inverse_sym_W_transpose(WtV), V, atol=1e-8)
    z = s.apply_inverse_sym_W_transpose(s.apply_inverse_sym_W(y))
    assert np.allclose(z, np.linalg.solve(K, y), atol=1e-6)


@pytest.mark.parametrize("sym", [True, False], ids=["sym", "lazy"])
def test_port_sym_surface_matches_reference(monkeypatch, sym):
    """The solver-level ``W`` surface against the JAX solver on the rank-16
    rig's data and pivots: ``sym=True``, and the lazy factors of a non-sym
    solver."""
    r = _SYM_RIGS.get(16) or _SYM_RIGS.setdefault(16, SymRig(16))
    x = r.x
    V = np.random.default_rng(7).standard_normal((len(x), 2))

    def kern(pkg):
        return 1.1 * pkg.ExpSquaredKernel(2.0)

    gj, gt = _gp_pair(monkeypatch, kern, x, 1.0, min_size=64, rank=16,
                      sym=sym)
    sj, st = gj.solver, gt.solver
    assert st.sym == sym
    assert abs(st.log_determinant - sj.log_determinant) < 1e-9 * abs(
        sj.log_determinant)
    for name in ("apply_inverse_sym_W", "apply_inverse_sym_W_transpose",
                 "apply_inverse"):
        assert _rel(getattr(sj, name)(V), getattr(st, name)(V)) < (
            SKELETON), name
    assert _rel(sj.apply_sqrt(V.T), st.apply_sqrt(V.T)) < SKELETON


def test_port_sym_hutchinson_gradient_matches_reference(monkeypatch):
    """``sym=True`` with ``grad_mode="hutchinson"``: both packages draw the
    numpy probes of ``default_rng(seed + 1)``, so the symmetric estimators
    agree to 1e-7; against the dense exact gradient within the JAX
    package's bound (rtol 0.2, atol 0.5)."""
    x, y, yerr = _data(400)

    def kern(pkg):
        return 0.9 * pkg.ExpSquaredKernel(1.5)

    gj, gt = _gp_pair(monkeypatch, kern, x, yerr, min_size=64, rank=48,
                      sym=True, grad_mode="hutchinson", num_probes=64)
    g_j = gj.grad_log_likelihood(y)
    g_t = gt.grad_log_likelihood(y)
    np.testing.assert_allclose(g_t, g_j, rtol=1e-7,
                               atol=1e-7 * np.abs(g_j).max())
    ge = tgt.GP(kern(tk), device=DEV)
    ge.compute(x, yerr)
    assert np.allclose(g_t, ge.grad_log_likelihood(y), rtol=0.2, atol=0.5)


# ---------------------------------------------------------------------------
# kNN-guided pivots
# ---------------------------------------------------------------------------

def test_port_knn_indices_and_nd_sort_match_reference():
    rng = np.random.default_rng(3)
    x = rng.uniform(0, 5, (300, 2))
    ij, it = jax_knn(x, 6), tn.knn_indices(x, 6)
    assert it.shape == ij.shape == (300, 6) and it.dtype == np.int64
    # ties may order differently: compare the neighbor distances
    dj = np.linalg.norm(x[ij] - x[:, None, :], axis=-1)
    dt = np.linalg.norm(x[it] - x[:, None, :], axis=-1)
    np.testing.assert_allclose(np.sort(dt, 1), np.sort(dj, 1), atol=1e-12)
    np.testing.assert_array_equal(it[:, 0], np.arange(300))
    perm = tn.nd_sort_samples(x)
    assert sorted(perm.tolist()) == list(range(300))
    d0 = np.linalg.norm(x[perm] - x[0], axis=1)
    assert np.all(np.diff(d0) >= 0)
    np.testing.assert_allclose(
        d0, np.linalg.norm(x[jgt.neighbors.nd_sort_samples(x)] - x[0],
                           axis=1), atol=1e-12)
    with pytest.raises(ValueError):
        tn.nd_sort_samples(x[:, 0])


def test_port_knn_pivots_match_reference(sym_rig):
    """The same neighbor matrix to both packages, on the rig's data:
    identical pivot integers (neighbor-guided FPS, no ACA walk) and
    likelihoods within 1e-9."""
    x, rank = sym_rig.x, sym_rig.rank
    yerr = np.ones(len(x))
    y = np.sin(0.3 * x[:, 0])
    nns = tn.knn_indices(x, 8)
    sj = JH.HODLRSolver(1.1 * jk.ExpSquaredKernel(2.0), min_size=64,
                        rank=rank)
    sj.compute(x, yerr, nns=nns)
    st = tgt.HODLRSolver(1.1 * tk.ExpSquaredKernel(2.0), min_size=64,
                         rank=rank, device=DEV)
    st.compute(x, yerr, nns=nns)
    for a, b in zip(sj._struct.levels, st._struct.levels):
        np.testing.assert_array_equal(a["row_piv"], b["row_piv"])
        np.testing.assert_array_equal(a["col_piv"], b["col_piv"])
    ll_j, ll_t = (-0.5 * (s.dot_solve(y) + s.log_determinant
                          + len(x) * np.log(2 * np.pi)) for s in (sj, st))
    assert abs(ll_t - ll_j) < 1e-9 * abs(ll_j)


def test_port_knn_option_vs_dense():
    """``knn=8`` draws the neighbor matrix itself and stays at the dense
    oracle's accuracy (the bounds of ``tests/test_hodlr.py``)."""
    x, y, yerr = _data(500)
    kt = 1.2 * tk.ExpSquaredKernel(2.0)
    K = _dense(kt, x, yerr)
    _, ld_true = np.linalg.slogdet(K)
    s = tgt.HODLRSolver(kt, min_size=64, rank=32, knn=8, device=DEV)
    s.compute(x, yerr)
    assert abs(s.log_determinant - ld_true) < 1e-3
    at = np.linalg.solve(K, y)
    a = s.apply_inverse(y)
    assert np.linalg.norm(a - at) / np.linalg.norm(at) < 1e-4
    # the neighbor-guided pivots differ from the ACA walk's
    s_aca = tgt.HODLRSolver(kt, min_size=64, rank=32, device=DEV)
    s_aca.compute(x, yerr)
    assert not np.array_equal(s._struct.flat["rp_all"],
                              s_aca._struct.flat["rp_all"])


def test_port_hodlr_ignores_sparse_nns_forms():
    """CSR tuples, ragged listings and bare triggers are sparse-solver
    structures: the hierarchical solver accepts and ignores them."""
    rng = np.random.default_rng(2)
    n = 96
    x = np.sort(rng.uniform(0, 10, n))
    y = np.sin(x)
    k = tk.ExpSquaredKernel(metric=1.0)
    base = tgt.GP(k, solver=tgt.HODLRSolver, min_size=32, device=DEV)
    base.compute(x, 0.1)
    ll0 = base.log_likelihood(y)
    ragged = np.array(
        [np.flatnonzero(np.abs(x - xi) < 1.0) for xi in x], dtype=object)
    for nns in (True, ragged, tn.ragged_to_csr(ragged)):
        gp = tgt.GP(k, solver=tgt.HODLRSolver, min_size=32, device=DEV)
        gp.compute(x, 0.1, nns=nns)
        np.testing.assert_allclose(gp.log_likelihood(y), ll0, rtol=1e-8)
