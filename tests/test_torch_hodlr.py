# -*- coding: utf-8 -*-
"""The port's HODLR factor, solve, matvec, likelihood and gradients held
against the JAX package's transposed cascade, in float64 on the CPU.

Two rigs: the n=600 ExpSquared rig of ``tests/test_ops.py`` (3 levels) and
an n=2000 Matern32 + ExpSquared rig (4 levels). The JAX structure is set to
its transposed layout and its ACA pivots are transplanted into the port
with ``convert.structure_from_arrays``, so every comparison is of two
factorizations over the same skeletons, not of two pivot walks.

Tolerances. The two packages run the same float64 algorithm in a different
summation order, and most results agree to 1e-10 or better. One stage does
not: the skeleton interpolant ``Q`` solves the ridge system ``G Q = M^T R``
whose gram sits at its ridge floor (cond(G) ~ 5e14 on both rigs), so the
two LAPACKs' rounding moves the skeleton products ``C Q^T`` by ~5e-10
relative. A solve or matvec through each package's own skeletons inherits
that (measured 2e-10 to 2e-9) and is held to 1e-8; the same solve and
matvec code run on one shared set of factors are held to 1e-10, and so are
the log-determinant and the likelihood, which that perturbation does not
move at first order.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from george_tpu import kernels as jk
from george_tpu.solvers import hodlr as JH
import george_tpu_torch as gtt
from george_tpu_torch import convert
from george_tpu_torch import kernels as tk
from george_tpu_torch.solvers import hodlr as TH

torch.set_num_threads(2)

SHARED = 1e-10      # same inputs, summation order only
SKELETON = 1e-8     # through each package's own ridge-solved skeletons


def _t(a):
    return torch.as_tensor(np.array(a))


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(a))


class Rig(object):
    """One dataset, the JAX struct with ACA pivots, the port struct with the
    same pivots, and both packages' arguments."""

    def __init__(self, name):
        rng = np.random.default_rng(11)
        if name == "n600":
            n, span, ms, rank = 600, 40.0, 64, 16
            x = np.sort(rng.uniform(0, span, n))[:, None]
            kj = 1.1 * jk.ExpSquaredKernel(2.0)
            kt = 1.1 * tk.ExpSquaredKernel(2.0)
            noise = 1.0
        else:
            n, span, ms, rank = 2000, 200.0, 64, 12
            x = np.sort(rng.uniform(0, span, n))[:, None]
            kj = 1.0 * jk.Matern32Kernel(0.5) + 0.5 * jk.ExpSquaredKernel(4.0)
            kt = 1.0 * tk.Matern32Kernel(0.5) + 0.5 * tk.ExpSquaredKernel(4.0)
            noise = 0.25
        self.n, self.ms, self.rank, self.kj, self.kt = n, ms, rank, kj, kt
        self.theta = np.asarray(kj.parameter_vector)
        st = JH.build_structure(n, min_size=ms, rank=rank, seed=42,
                                x_sorted=x)
        st.transposed = True
        self.xpad = np.concatenate([x, np.repeat(x[-1:], st.n_pad - n, 0)])
        self.valid = np.zeros(st.n_pad, bool)
        self.valid[:n] = True
        JH.select_aca_pivots(kj.pair_fn, self.theta, self.xpad, self.valid,
                             st)
        self.st = st
        self.stt = convert.structure_from_arrays(
            n, ms, rank, 42,
            [(lev["row_piv"], lev["col_piv"]) for lev in st.levels])
        self.dp = np.ones(st.n_pad)
        self.dp[:n] = noise
        self.y = np.zeros(st.n_pad)
        self.y[:n] = np.sin(0.3 * x[:, 0]) + 0.3 * rng.standard_normal(n)
        self.rhs = rng.standard_normal((st.n_pad, 3))
        self.jargs = (kj.pair_fn, jnp.asarray(self.theta),
                      jnp.asarray(self.xpad), jnp.asarray(self.valid),
                      jnp.asarray(self.dp))
        self.targs = (kt.pair_fn, _t(self.theta), _t(self.xpad),
                      _t(self.valid), _t(self.dp))
        pair = kj.pair_fn
        # the JAX side runs jitted: eager dispatch of the factorization's
        # graph costs ten times its compile here
        self.fj, self.ldj = jax.jit(
            lambda th, *a: JH.hodlr_factor(pair, th, *a, st)
        )(*self.jargs[1:])
        self.ft, self.ldt = TH.hodlr_factor(*self.targs, self.stt)

    def ll_jax(self, th):
        pair, _, xp, vl, dp = self.jargs
        f, ld = JH.hodlr_factor(pair, th, xp, vl, dp, self.st)
        y = jnp.asarray(self.y)
        z = JH.hodlr_solve(f, self.st, y)
        return -0.5 * (jnp.dot(y, z) + ld + self.n * jnp.log(2 * jnp.pi))

    def ll_port(self, th):
        pair, _, xp, vl, dp = self.targs
        f, ld = TH.hodlr_factor(pair, th, xp, vl, dp, self.stt)
        y = _t(self.y)
        z = TH.hodlr_solve(f, self.stt, y)
        return -0.5 * (torch.dot(y, z) + ld + self.n * np.log(2 * np.pi))

    def jax_factors_as_torch(self):
        return {"Lleaf": _t(self.fj["Lleaf"]),
                "levels": [tuple(_t(a) for a in lev)
                           for lev in self.fj["levels"]]}


_RIGS = {}


@pytest.fixture(params=["n600", "n2000"])
def rig(request):
    if request.param not in _RIGS:
        _RIGS[request.param] = Rig(request.param)
    return _RIGS[request.param]


def test_structure_transplant(rig):
    assert (rig.stt.L, rig.stt.m, rig.stt.n_pad, rig.stt.rank) == (
        rig.st.L, rig.st.m, rig.st.n_pad, rig.st.rank)
    for name in ("rp_all", "cp_all"):
        np.testing.assert_array_equal(rig.stt.flat[name], rig.st.flat[name])
    assert rig.stt.flat["pair_offset"] == [
        int(v) for v in rig.st.flat["pair_offset"]]
    assert rig.stt.L >= 3


def test_factor_matches(rig):
    assert abs(float(rig.ldt) - float(rig.ldj)) / abs(float(rig.ldj)) < (
        SHARED)
    assert _rel(rig.fj["Lleaf"], rig.ft["Lleaf"]) < SHARED
    for lev, (Zj, _, Cj), (Zt, _, Ct) in zip(
            rig.st.levels, rig.fj["levels"], rig.ft["levels"]):
        assert Zt.shape == Zj.shape and Ct.shape == Cj.shape
        # the C half of Z is kernel columns, with no solve in it
        shape = (lev["c"], lev["p"], 2, lev["s"])
        assert _rel(np.asarray(Zj).reshape(shape)[:, :, 0],
                    Zt.numpy().reshape(shape)[:, :, 0]) < SHARED


def test_skeleton_products_match(rig):
    """``C Q^T`` per sibling pair: the ridge-regime quantity (see the
    module docstring)."""
    pair = rig.kj.pair_fn
    lj = jax.jit(lambda *a: JH._all_lowrank_t(pair, *a, rig.st,
                                              jnp.float64))(*rig.jargs[1:4])
    lt = TH._all_lowrank_t(*rig.targs[:4], rig.stt)
    for (Cj, Qj), (Ct, Qt) in zip(lj, lt):
        assert _rel(Cj, Ct) < SHARED
        pj = np.einsum("cps,cpt->pst", np.asarray(Cj), np.asarray(Qj))
        pt = np.einsum("cps,cpt->pst", Ct.numpy(), Qt.numpy())
        assert _rel(pj, pt) < SKELETON


def test_solve_matches(rig):
    zj = JH.hodlr_solve(rig.fj, rig.st, jnp.asarray(rig.rhs))
    # the port's cascade on the JAX package's factors: summation order only
    zs = TH.hodlr_solve(rig.jax_factors_as_torch(), rig.stt, _t(rig.rhs))
    assert _rel(zj, zs) < SHARED
    # end to end through the port's own factorization
    zt = TH.hodlr_solve(rig.ft, rig.stt, _t(rig.rhs))
    assert zt.shape == zj.shape
    assert _rel(zj, zt) < SKELETON
    # one right-hand side as a vector
    z1 = TH.hodlr_solve(rig.ft, rig.stt, _t(rig.rhs[:, 0]))
    assert z1.shape == (rig.stt.n_pad,)
    assert _rel(np.asarray(zj)[:, 0], z1) < SKELETON


def test_matvec_matches(rig):
    pair = rig.kj.pair_fn
    mj = jax.jit(lambda *a: JH.hodlr_matvec(pair, *a[:4], rig.st, a[4]))(
        *rig.jargs[1:], jnp.asarray(rig.rhs))
    mt = TH.hodlr_matvec(*rig.targs, rig.stt, _t(rig.rhs))
    assert _rel(mj, mt) < SKELETON
    Xt = jnp.asarray(rig.rhs.T)
    fj = JH._matvec_factors_t(rig.fj, rig.st, Xt)
    fs = TH._matvec_factors_t(rig.jax_factors_as_torch(), rig.stt,
                              _t(rig.rhs.T))
    assert _rel(fj, fs) < SHARED
    ft = TH._matvec_factors_t(rig.ft, rig.stt, _t(rig.rhs.T))
    assert _rel(fj, ft) < SKELETON
    # the factors rebuild the compressed operator: matvec from the
    # factors == matvec with fresh assembly, within the port
    assert _rel(mt.T, ft) < SHARED


def test_refined_solve_matches(rig):
    pair = rig.kj.pair_fn
    zj = jax.jit(lambda *a: JH.hodlr_solve_refined(
        pair, *a[:4], rig.st, a[4], a[5], steps=1))(
            *rig.jargs[1:], rig.fj, jnp.asarray(rig.y))
    zt = TH.hodlr_solve_refined(*rig.targs, rig.stt, rig.ft, _t(rig.y),
                                steps=1)
    assert _rel(zj, zt) < SKELETON


def test_loglike_and_exact_gradient_match(rig):
    lj, gj = jax.jit(jax.value_and_grad(rig.ll_jax))(jnp.asarray(rig.theta))
    th = _t(rig.theta).requires_grad_(True)
    lt = rig.ll_port(th)
    (gt,) = torch.autograd.grad(lt, th)
    assert abs(float(lt.detach()) - float(lj)) / abs(float(lj)) < SHARED
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-8)


@pytest.mark.parametrize("refine", [0, 1])
def test_hutchinson_matches(rig, refine):
    """Both sides get the same Rademacher probes. The gradient is a
    difference of a quadratic and a trace term, each much larger than a
    small component, so it is held to 1e-8 relative to its largest
    component."""
    key = jax.random.PRNGKey(0)
    P = 8
    pair = rig.kj.pair_fn
    lj, gj = jax.jit(
        lambda th, *a: JH.hodlr_loglike_and_grad_hutchinson(
            pair, th, *a, rig.st, key, num_probes=P, n_real=rig.n,
            refine_steps=refine)
    )(*rig.jargs[1:], jnp.asarray(rig.y))
    probes = np.array(jax.random.rademacher(key, (P, rig.st.n_pad),
                                            dtype=jnp.float64))
    lt, gt = TH.hodlr_loglike_and_grad_hutchinson(
        *rig.targs, _t(rig.y), rig.stt, num_probes=P, n_real=rig.n,
        refine_steps=refine, probes=probes)
    assert abs(float(lt) - float(lj)) / abs(float(lj)) < SHARED
    gj = np.asarray(gj)
    np.testing.assert_allclose(gt.numpy(), gj, rtol=1e-8,
                               atol=1e-8 * np.abs(gj).max())


def test_hutchinson_generator_probes():
    """Probes drawn from an explicit ``torch.Generator`` are reproducible
    and the result tracks the exact gradient."""
    rig = _RIGS.get("n600") or Rig("n600")
    _RIGS["n600"] = rig
    out = []
    for _ in range(2):
        g = torch.Generator().manual_seed(5)
        out.append(TH.hodlr_loglike_and_grad_hutchinson(
            *rig.targs, _t(rig.y), rig.stt, generator=g, num_probes=64,
            n_real=rig.n))
    assert float(out[0][0]) == float(out[1][0])
    assert torch.equal(out[0][1], out[1][1])
    th = _t(rig.theta).requires_grad_(True)
    (g_exact,) = torch.autograd.grad(rig.ll_port(th), th)
    err = np.abs(out[0][1].numpy() - g_exact.numpy())
    assert np.all(err <= 0.2 * np.abs(g_exact.numpy()) + 0.5)
    with pytest.raises(ValueError):
        TH.hodlr_loglike_and_grad_hutchinson(*rig.targs, _t(rig.y), rig.stt)


def _residual_pivot(A, I, J, k):
    """|R_k[I[k], J[k]]| / |A[I[0], J[0]]|: the ACA residual at slot k given
    the first k pivots (the cross approximation's Schur complement)."""
    if k == 0:
        return 1.0
    I0, J0 = list(I[:k]), list(J[:k])
    R = A[I[k], J[k]] - A[I[k], J0] @ np.linalg.solve(A[np.ix_(I0, J0)],
                                                      A[I0, J[k]])
    return abs(R) / abs(A[I[0], J[0]])


def test_aca_pivots_match_reference():
    """The port's host-f64 ACA walk picks the JAX walk's pivots.

    Index equality holds in every slot the kernel decides. Once a pair's
    residual has fallen to rounding noise the argmax is a tie among noise
    entries, and the two walks (different summation order in the residual
    downdate) may break it differently. On this rig (seed 11, n=600) that
    happens only at level 3, in slots 14-15 of its four pairs, where the
    residual pivot is below 1e-13 of the first; there the walks are held to
    agree up to that slot."""
    rig = _RIGS.get("n600") or Rig("n600")
    _RIGS["n600"] = rig
    st2 = TH.build_structure(rig.n, min_size=rig.ms, rank=rig.rank, seed=42,
                             x_sorted=rig.xpad[:rig.n])
    TH.select_aca_pivots(rig.kt.pair_fn, rig.theta, rig.xpad, rig.valid,
                         st2)
    pair = rig.kt.pair_fn
    flipped = []
    for li, (a, b) in enumerate(zip(rig.st.levels, st2.levels)):
        s = a["s"]
        for q in range(a["p"]):
            same = (a["row_piv"][q] == b["row_piv"][q]) & (
                a["col_piv"][q] == b["col_piv"][q])
            if same.all():
                continue
            k = int(np.argmin(same))
            xb = _t(rig.xpad).reshape(a["p"], 2, s, -1)[q]
            A = pair(_t(rig.theta), xb[0][:, None, :],
                     xb[1][None, :, :]).numpy()
            I = a["row_piv"][q] - q * 2 * s
            J = a["col_piv"][q] - q * 2 * s - s
            assert _residual_pivot(A, I, J, k) < 1e-13, (li, q, k)
            flipped.append((li + 1, k))
    assert {lev for lev, _ in flipped} <= {3}
    assert all(k >= 14 for _, k in flipped)


def test_float32_exact_gradient_no_worse_than_reference(rig):
    """The float32 exact gradient of both packages on the same pivots,
    each measured as its largest distance from the float64 gradient over
    max|g|: the port must be no worse than the JAX package by more than 2x
    (measured: 1.102e-3 vs 1.097e-3 on the n = 600 rig, 1.022e-5 vs
    1.005e-5 on the n = 2000 rig), so the float32 gradient error is the
    algorithm's (the skeleton solves at their ridge floor), not the
    port's."""
    th = _t(rig.theta).requires_grad_(True)
    (g64,) = torch.autograd.grad(rig.ll_port(th), th)
    g64 = g64.numpy()
    pair = rig.kj.pair_fn
    _, xp, vl, dp = rig.jargs[1:]

    def f32(a):
        return jnp.asarray(np.asarray(a), dtype=jnp.float32)

    def ll_jax32(th):
        f, ld = JH.hodlr_factor(pair, th, f32(xp), vl, f32(dp), rig.st)
        y = f32(rig.y)
        z = JH.hodlr_solve(f, rig.st, y)
        return -0.5 * (jnp.dot(y, z) + ld
                       + jnp.float32(rig.n * np.log(2 * np.pi)))

    gj = jax.jit(jax.grad(ll_jax32))(f32(rig.theta))
    assert gj.dtype == jnp.float32
    pt, _, xpt, vlt, dpt = rig.targs
    th32 = torch.as_tensor(rig.theta, dtype=torch.float32).requires_grad_(
        True)
    f, ld = TH.hodlr_factor(pt, th32, xpt.float(), vlt, dpt.float(),
                            rig.stt)
    y = torch.as_tensor(rig.y, dtype=torch.float32)
    ll = -0.5 * (torch.dot(y, TH.hodlr_solve(f, rig.stt, y)) + ld
                 + rig.n * np.log(2 * np.pi))
    (gt,) = torch.autograd.grad(ll, th32)
    assert gt.dtype == torch.float32
    scale = np.abs(g64).max()
    d_jax = np.abs(np.asarray(gj, np.float64) - g64).max() / scale
    d_port = np.abs(gt.double().numpy() - g64).max() / scale
    assert np.isfinite(d_port) and d_port <= 2.0 * d_jax


def test_ex_swaps_hold_value_and_gradients_to_reference(rig):
    """The factorization's ``inv_ex`` and ``_RidgeSolve`` (no device read):
    the float64 value and its gradients in theta, the diagonal and the
    residual against the JAX package's, held as
    ``test_loglike_and_exact_gradient_match`` holds the value and theta
    gradient."""
    pair = rig.kj.pair_fn
    _, _, xp, vl, _ = rig.jargs

    def ll_jax(th, dp, y):
        f, ld = JH.hodlr_factor(pair, th, xp, vl, dp, rig.st)
        z = JH.hodlr_solve(f, rig.st, y)
        return -0.5 * (jnp.dot(y, z) + ld + rig.n * jnp.log(2 * jnp.pi))

    lj, gj = jax.jit(jax.value_and_grad(ll_jax, argnums=(0, 1, 2)))(
        jnp.asarray(rig.theta), jnp.asarray(rig.dp), jnp.asarray(rig.y))
    pt, _, xpt, vlt, _ = rig.targs

    def ll_port(th, dp, y):
        f, ld = TH.hodlr_factor(pt, th, xpt, vlt, dp, rig.stt)
        z = TH.hodlr_solve(f, rig.stt, y)
        return -0.5 * (torch.dot(y, z) + ld + rig.n * np.log(2 * np.pi))

    gt, lt = torch.func.grad_and_value(ll_port, argnums=(0, 1, 2))(
        _t(rig.theta), _t(rig.dp), _t(rig.y))
    assert abs(float(lt) - float(lj)) / abs(float(lj)) < SHARED
    for a, b in zip(gt, gj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-8,
                                   atol=1e-8 * np.abs(np.asarray(b)).max())


def test_singular_core_gives_non_finite_not_an_error():
    """A singular SMW core gives a non-finite inverse and log-determinant,
    as the JAX package's ``inv`` does, and raises nothing."""
    core = torch.zeros(2, 4, 4, dtype=torch.float64)
    inv, ld = TH._core_inv_slogdet(core)
    assert not bool(torch.isfinite(inv).all())
    assert not bool(torch.isfinite(ld).any())


# -- the CUDA graph route of HODLRSolver.loglike_fn, on the CPU ------------

class _EagerGraph(object):
    """``_LoglikeGraph`` with its replay replaced by an eager value and
    gradient, on the CPU: the route's plumbing without a card."""

    @staticmethod
    def holds(args):
        return True

    def __init__(self, f, key, args):
        self.key, self.f = key, f

    def run(self, args):
        grads, value = torch.func.grad_and_value(self.f, argnums=(0, 1, 2))(
            *args)
        return (value,) + tuple(grads)


def _route_gp():
    """A HODLR GP on 700 sorted points (3 levels), its active parameters
    including the white noise, so that the diagonal carries a gradient."""
    rng = np.random.default_rng(3)
    n = 700
    x = np.sort(rng.uniform(0, 60, n))
    y = np.sin(0.3 * x) + 0.3 * rng.standard_normal(n)
    k = 1.2 * tk.ExpSquaredKernel(4.0) + 0.3 * tk.Matern32Kernel(2.0)
    gp = gtt.GP(k, solver=TH.HODLRSolver, min_size=64, rank=12,
                device="cpu", white_noise=np.log(0.01), fit_white_noise=True)
    gp.compute(x, 0.3)
    theta0 = torch.as_tensor(gp.get_parameter_vector())
    return gp, gp.log_prob_fn(x, y, 0.3), theta0


@pytest.mark.parametrize("which", [0, 1, 2])
def test_graph_route_plumbing_matches_eager(monkeypatch, which):
    """With the replay replaced by an eager value and gradient,
    ``grad_and_value(log_prob_fn)`` and ``vmap`` of it over 3 chains give
    the eager path's numbers bit for bit; a call on the route counts one
    replay, the first one capture, and ``vmap`` neither."""
    gp, f, theta0 = _route_gp()
    rng = np.random.default_rng(which)
    thetas = theta0 + 0.01 * torch.as_tensor(
        rng.standard_normal((3,) + tuple(theta0.shape)))
    gv = torch.func.grad_and_value(f)
    want = gv(thetas[0])
    want_b = torch.func.vmap(gv)(thetas)
    monkeypatch.setattr(TH, "_LoglikeGraph", _EagerGraph)
    captures, replays = TH.graph_captures, TH.graph_replays
    got = gv(thetas[0])
    got_b = torch.func.vmap(gv)(thetas)
    assert (TH.graph_captures, TH.graph_replays) == (captures + 1,
                                                     replays + 1)
    assert gp.solver._graph is not None
    for a, b in zip(got + got_b, want + want_b):
        assert torch.equal(a, b)
    assert not bool(torch.equal(want_b[0][0], want_b[0][1]))


@pytest.mark.parametrize("case", ["cpu", "sharded", "value_only"])
def test_graph_route_stays_eager(monkeypatch, case):
    """A CPU call (the real graph wants CUDA), a sharded structure and a
    value-only call take the eager sweeps: no capture, no replay."""
    gp, f, theta0 = _route_gp()
    if case != "cpu":
        monkeypatch.setattr(TH, "_LoglikeGraph", _EagerGraph)
    captures, replays = TH.graph_captures, TH.graph_replays
    solver = gp.solver
    if case == "sharded":
        args = (theta0[2:], torch.ones(solver._struct.n, dtype=torch.float64),
                torch.ones(solver._struct.n, dtype=torch.float64))
        args = tuple(a.requires_grad_(True) for a in args)
        assert solver._graph_route(solver._generation, args)
        monkeypatch.setattr(solver._struct, "shard", object())
        assert not solver._graph_route(solver._generation, args)
    elif case == "cpu":
        g, v = torch.func.grad_and_value(f)(theta0)
        assert bool(torch.isfinite(g).all()) and bool(torch.isfinite(v))
    else:
        v = f(theta0)
        t = theta0.clone().requires_grad_(True)
        with torch.no_grad():
            assert float(f(t)) == float(v)
    assert (TH.graph_captures, TH.graph_replays) == (captures, replays)
    assert solver._graph is None


@pytest.mark.parametrize("how", ["grad", "vmap_grad", "jvp", "hessian_B",
                                 "hessian_G", "double_backward"])
def test_ridge_solve_derivatives_are_solves(how):
    """The skeleton interpolation's ``_RidgeSolve`` (its own factor and
    solve, no read of the error flag) differentiates as
    ``torch.linalg.solve`` does, on a batch of symmetric ridge systems:
    reverse mode under ``torch.func`` and plain autograd, ``vmap`` of it,
    ``jvp``, Hessians in either argument and a double backward."""
    gen = torch.Generator().manual_seed(0)
    p, c, s = 5, 6, 4

    def rand(*shape):
        return torch.randn(*shape, generator=gen, dtype=torch.float64)

    M = rand(p, c, c)
    G = M @ M.mT + 0.1 * torch.eye(c, dtype=torch.float64)
    B, W = rand(p, c, s), rand(p, c, s)

    def mine(G, B):
        return (TH._RidgeSolve.apply(G, B)[0] * W).sum().sin()

    def ref(G, B):
        return (torch.linalg.solve(G, B) * W).sum().sin()

    def plain_double(f):
        Gr, Br = G.clone().requires_grad_(True), B.clone().requires_grad_(True)
        gG, gB = torch.autograd.grad(f(Gr, Br), (Gr, Br), create_graph=True)
        return torch.autograd.grad(gG.sum() + gB.sum(), (Gr, Br))

    Gs = G + 0.01 * rand(3, p, c, c)
    Bs = B.expand(3, p, c, s)
    dG, dB = rand(p, c, c), rand(p, c, s)
    run = {
        "grad": lambda f: torch.func.grad(f, (0, 1))(G, B),
        "vmap_grad": lambda f: torch.func.vmap(torch.func.grad(f, (0, 1)))(
            Gs, Bs),
        "jvp": lambda f: torch.func.jvp(f, (G, B), (dG, dB)),
        "hessian_B": lambda f: (torch.func.hessian(lambda b: f(G, b))(B),),
        "hessian_G": lambda f: (torch.func.hessian(lambda g: f(g, B))(G),),
        "double_backward": plain_double,
    }[how]
    got, want = run(mine), run(ref)
    assert float(mine(G, B)) == float(ref(G, B))
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= 1e-13 * float(b.abs().max())
