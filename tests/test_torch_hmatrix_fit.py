# -*- coding: utf-8 -*-
"""Fitting the 2-D H-matrix model through the port: the rematerializing far
factors (``hmatrix._FarFactors``) that keep reverse mode's memory at the
factors themselves, the bytes one fused-likelihood forward keeps for its
backward, and ``minimize`` against the JAX package's.

Tolerances. The Function runs the same chunks of the same arithmetic as
plain autograd through :func:`hmatrix_compress`: value, reverse-mode
gradient, ``jvp`` and ``vmap`` agree to 1e-12 relative in float64. The
fused likelihood's value and gradient against the JAX package are held at
``REL_FUSED`` (1e-6), as in ``tests/test_torch_hmatrix_solver.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import george_tpu as jgt
from george_tpu.sampling import optimize as JO
from george_tpu.solvers import hmatrix as JM
import george_tpu_torch as tgt
from george_tpu_torch.convert import kernel_from_reference
from george_tpu_torch.sampling import optimize as TO
from george_tpu_torch.solvers import hodlr as TH
from george_tpu_torch.solvers import hmatrix as TM

torch.set_num_threads(2)

DEV = "cpu"   # the port's entry points default to the card
REL_FUSED = 1e-6


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _data_2d(n, seed=0, span=7.0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, span, (n, 2))
    y = (np.sin(x[:, 0]) * np.cos(0.7 * x[:, 1])
         + 0.1 * rng.standard_normal(n))
    return x, y, 0.1 * np.ones(n)


def _solver(n=600, **kw):
    x, y, yerr = _data_2d(n)
    kt = 1.0 * tgt.kernels.ExpSquaredKernel([1.5, 1.5], ndim=2)
    s = TM.HMatrixSolver(kt, min_size=16, rank=12, device=DEV, **kw)
    s.compute(x, yerr)
    return s, x, y, yerr


@pytest.fixture(params=["one chunk", "many chunks"])
def far(request, monkeypatch):
    """The solver's far blocks, at the default chunk budget (one chunk a
    depth on this rig) and at one so small that every depth splits into
    several chunks of pairs."""
    if request.param == "many chunks":
        monkeypatch.setattr(TH, "_CHUNK_BYTES", 40_000)
    s, *_ = _solver()
    fb = TM._FarBlocks(s.kernel.pair_fn, s._xpad, s._valid, s._hs,
                       s.tol_abs)
    levels = {li for li, _ in fb.chunks}
    assert len(levels) == len(s._hs.far) >= 2
    if request.param == "many chunks":
        assert len(fb.chunks) > 2 * len(levels)
    return s, fb


def _plain(s, theta):
    far = TM.hmatrix_compress(s.kernel.pair_fn, theta, s._xpad, s._valid,
                              s._hs, ridge_floor=s.tol_abs)
    return tuple(t for cq in far for t in cq)


def _weights(outs, seed):
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(rng.standard_normal(tuple(t.shape)))
            for t in outs]


def test_far_factors_function_matches_plain_autograd(far):
    """Value, reverse-mode gradient, ``jvp`` and ``vmap`` over 2 thetas of
    the rematerializing Function against plain autograd through
    :func:`hmatrix_compress`, to 1e-12 relative in float64."""
    s, fb = far
    theta0 = s._theta.clone()

    def remat(th):
        return TM._FarFactors.apply(fb, th)

    ref, got = _plain(s, theta0), remat(theta0)
    assert len(got) == len(ref) == 2 * len(s._hs.far)
    for a, b in zip(got, ref):
        assert a.shape == b.shape and _rel(a.numpy(), b.numpy()) < 1e-12
    W = _weights(ref, 1)

    def loss(fn):
        return lambda th: sum(torch.sum(w * t) for w, t in zip(W, fn(th)))

    def autograd_plain(th):
        th = th.clone().requires_grad_(True)
        return torch.autograd.grad(loss(lambda t: _plain(s, t))(th), th)[0]

    # the reference is torch.autograd's backward. torch.func.grad runs the
    # same graph's backward with create_graph=True, whose formulas round
    # differently, and the ridge-floor solves (cond(G) ~ 1e14) amplify that
    # to ~1e-3 on these raw factors (~1e-9 on the blocks C Q^T); the
    # Function's backward runs its vjps under no_grad, so in either
    # transform it is torch.autograd's arithmetic
    g_ref = autograd_plain(theta0)
    th = theta0.clone().requires_grad_(True)
    (g_ag,) = torch.autograd.grad(loss(remat)(th), th)
    assert _rel(g_ag.numpy(), g_ref.numpy()) < 1e-12
    g_func = torch.func.grad(loss(remat))(theta0)
    assert _rel(g_func.numpy(), g_ref.numpy()) < 1e-12

    tangent = torch.as_tensor(np.random.default_rng(2).standard_normal(
        theta0.shape))
    _, t_ref = torch.func.jvp(lambda th: _plain(s, th), (theta0,),
                              (tangent,))
    _, t_got = torch.func.jvp(remat, (theta0,), (tangent,))
    for a, b in zip(t_got, t_ref):
        assert _rel(a.numpy(), b.numpy()) < 1e-12

    thetas = torch.stack([theta0, theta0 + torch.tensor([0.1, -0.05,
                                                         0.08])])
    v_got = torch.func.vmap(remat)(thetas)
    for c in range(2):
        for a, b in zip(v_got, _plain(s, thetas[c])):
            assert _rel(a[c].numpy(), b.numpy()) < 1e-12
    gv_got = torch.func.vmap(torch.func.grad(loss(remat)))(thetas)
    for c in range(2):
        assert _rel(gv_got[c].numpy(), autograd_plain(thetas[c]).numpy()) < (
            1e-12)


def test_near_values_function_matches_plain_autograd():
    """The stored near field's rematerializing Function (``_NearValues``):
    value, and the reverse-mode gradient of a weighted sum of it through
    ``torch.autograd``, ``torch.func.grad`` and ``vmap`` over 2 thetas,
    against plain autograd through :func:`hmatrix_near_values`, to 1e-12
    relative in float64."""
    s, *_ = _solver()
    assert s._near is not None
    theta0 = s._theta.clone()

    def plain(th):
        return TM.hmatrix_near_values(s.kernel.pair_fn, th, s._xpad,
                                      s._valid, s._hs)

    def remat(th):
        return TM._NearValues.apply(s._near_slots, th)

    for a, b in zip(remat(theta0), plain(theta0)):
        assert _rel(a.numpy(), b.numpy()) < 1e-12
    W = _weights(plain(theta0), 4)

    def loss(fn):
        return lambda th: sum(torch.sum(w * t) for w, t in zip(W, fn(th)))

    def autograd(fn, th):
        th = th.clone().requires_grad_(True)
        return torch.autograd.grad(loss(fn)(th), th)[0].numpy()

    g_ref = autograd(plain, theta0)
    assert _rel(autograd(remat, theta0), g_ref) < 1e-12
    assert _rel(torch.func.grad(loss(remat))(theta0).numpy(), g_ref) < 1e-12
    thetas = torch.stack([theta0, theta0 + torch.tensor([0.1, -0.05,
                                                         0.08])])
    gv = torch.func.vmap(torch.func.grad(loss(remat)))(thetas)
    for c in range(2):
        assert _rel(gv[c].numpy(), autograd(plain, thetas[c])) < 1e-12


def test_far_matvec_in_pair_groups(monkeypatch):
    """A wide block makes the far field's product run over groups of pairs
    (here one pair per group): the same result as one group, in value and
    in reverse mode through the factors."""
    s, *_ = _solver()
    X = torch.as_tensor(np.random.default_rng(3).standard_normal(
        (s._hs.n_pad, 5)))

    def run():
        far = [tuple(t.clone().requires_grad_(True) for t in cq)
               for cq in s._far]
        Y = TM.hmatrix_matvec(s.kernel.pair_fn, s._theta, s._xpad, s._valid,
                              s._diag_pad, s._hs, far, X,
                              near_vals=s._near)
        flat = [t for cq in far for t in cq]
        return Y, torch.autograd.grad(torch.sum(Y * X), flat)

    Y1, g1 = run()
    monkeypatch.setattr(TM, "_FAR_GROUP_BYTES", 1)
    Yg, gg = run()
    assert _rel(Yg.detach().numpy(), Y1.detach().numpy()) < 1e-13
    for a, b in zip(gg, g1):
        assert _rel(a.numpy(), b.numpy()) < 1e-13


def _saved_bytes(fn):
    """Bytes of the distinct storages that autograd saves for the backward
    while ``fn`` runs, and ``fn``'s result."""
    seen = {}

    def pack(t):
        st = t.untyped_storage()
        seen[st.data_ptr()] = st.nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn()
    return sum(seen.values()), out


def test_loglike_forward_saves_only_factors_and_vectors():
    """The CPU guard for reverse mode's memory at scale: one fused
    likelihood forward with the near field on the fly (as at n = 1e5 in
    2-D) keeps for its backward the far factors and a few padded vectors,
    not the pair function's intermediates.

    Bound: the far factors' bytes (saved by the solve and the
    log-determinant; one storage each) plus 16 vectors of ``n_pad``
    entries (measured: ``theta``, the padded diagonal and residual, the
    solution, the permutation, the unpadded inputs). Plain autograd
    through :func:`hmatrix_compress` keeps the kernel blocks ``M``, ``C``,
    ``R``, the ridge grams and the pair function's temporaries of every
    far pair, several times the factors: the same forward with the
    solver's parts routed that way must break the bound."""
    s, x, y, yerr = _solver(n=600, store_near=False)
    assert s._near is None
    hs = s._hs
    itemsize = s._theta.element_size()
    far_bytes = sum(t.numel() * itemsize for cq in s._far for t in cq)
    bound = far_bytes + 16 * hs.n_pad * 8

    def forward():
        args = [torch.tensor(a).requires_grad_(True)
                for a in (np.asarray(s.kernel.parameter_vector), yerr ** 2,
                          y)]
        return s.loglike_fn()(*args)

    saved, v = _saved_bytes(forward)
    assert np.isfinite(v.item())
    assert far_bytes <= saved <= bound, (saved, far_bytes, bound)

    s._parts = lambda th: _plain(s, th)      # the parent's outer graph
    saved_plain, v_plain = _saved_bytes(forward)
    assert abs(v_plain.item() - v.item()) < 1e-12 * abs(v.item())
    assert saved_plain > 2 * bound, (saved_plain, bound)


def test_backward_rules_record_no_graph():
    """``torch.func.grad`` (and so ``minimize`` and the samplers) runs every
    backward with ``create_graph=True``. The solver's backward rules run
    their per-chunk vjps under ``no_grad``, so they record nothing: with
    the near field stored or on the fly, the gradients of one fused
    likelihood come out with no graph behind them even when the backward
    is asked for one. A rule that recorded would keep every chunk's
    pair-function graph alive until the whole backward ends."""
    for store in (True, False):
        s, x, y, yerr = _solver(store_near=store)
        args = [torch.tensor(a).requires_grad_(True)
                for a in (np.asarray(s.kernel.parameter_vector), yerr ** 2,
                          y)]
        v = s.loglike_fn()(*args)
        grads = torch.autograd.grad(v, args, create_graph=True)
        assert not any(g.requires_grad for g in grads)
        g_ref = torch.autograd.grad(s.loglike_fn()(*args), args)
        for a, b in zip(grads, g_ref):
            assert _rel(a.numpy(), b.numpy()) < 1e-12


def _probes(seed, shape):
    return np.array(jax.random.rademacher(jax.random.PRNGKey(seed), shape,
                                          dtype=jnp.float64))


def test_port_minimize_matches_jax_minimize(monkeypatch):
    """``minimize(maxiter=2)`` on a small 2-D H-matrix GP in both packages,
    on the same data, SLQ probes and far and Nystrom pivots (seeded numpy
    in both): the same first value and gradient of the bounds-gated
    ``log_prob_fn`` (read from each package's first call of the objective
    it hands scipy) at ``REL_FUSED``, and on both a final objective below
    the first."""
    import scipy.optimize

    x, y, yerr = _data_2d(500, seed=4)
    kj = 1.0 * jgt.kernels.ExpSquaredKernel([1.2, 1.2], ndim=2)
    kt = kernel_from_reference(
        1.0 * tgt.kernels.ExpSquaredKernel([1.0, 1.0], ndim=2),
        kj.get_parameter_names(), kj.get_parameter_vector())
    kw = dict(min_size=16, rank=12, num_probes=16, num_steps=16)
    gj = jgt.GP(kj, solver=JM.HMatrixSolver, **kw)
    gj.compute(x, yerr)
    sj = gj.solver
    gt = tgt.GP(kt, solver=TM.HMatrixSolver, device=DEV,
                probes=_probes(sj.seed, (sj.num_probes, sj._hs.n_pad)),
                **kw)
    gt.compute(x, yerr)
    p0 = np.asarray(gj.get_parameter_vector())
    assert np.array_equal(p0, gt.get_parameter_vector())

    calls = []
    scipy_minimize = scipy.optimize.minimize

    def recording(fun, x0, **kwargs):
        seen = []
        calls.append(seen)

        def wrapped(v):
            out = fun(v)
            seen.append((np.array(v), float(out[0]), np.array(out[1])))
            return out

        return scipy_minimize(wrapped, x0, **kwargs)

    monkeypatch.setattr(scipy.optimize, "minimize", recording)
    rj = JO.minimize(gj, y, options={"maxiter": 2})
    rt = TO.minimize(gt, y, options={"maxiter": 2})
    (xj, fj, dj), (xt, ft, dt) = calls[0][0], calls[1][0]
    assert np.array_equal(xj, p0) and np.array_equal(xt, p0)
    assert abs(ft - fj) < REL_FUSED * abs(fj)
    assert _rel(dt, dj) < REL_FUSED
    for r, f0 in ((rj, fj), (rt, ft)):
        assert np.isfinite(r.fun) and r.fun < f0
        assert r.nit <= 2
    np.testing.assert_allclose(gt.get_parameter_vector(), rt.x)
    assert abs(rt.fun - rj.fun) < 1e-5 * abs(rj.fun)
