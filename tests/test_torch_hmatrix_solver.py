# -*- coding: utf-8 -*-
"""The port's ``HMatrixSolver`` and the GP through it, held against the JAX
package's in float64 on the CPU and against dense oracles.

Both sides see the same data, kernel parameters
(``convert.kernel_from_reference``) and probes: the JAX package draws the
SLQ probes as ``jax.random.rademacher(PRNGKey(seed), (num_probes, n_pad))``
and the gradient probes with ``PRNGKey(seed + 1)`` as ``(num_probes, n)``,
and the tests hand those arrays to the port's ``probes=`` and
``grad_probes=``. The far pivots and the Nystrom pivots are seeded numpy in
both packages; the float64 1-D whitener's ACA pivots are handed over with
``pivots=`` (the two walks may break noise-level ties apart).

Tolerances. On the 2-D Nystrom path the two packages run the same
arithmetic on the same whitener: the log-determinant, solves and
``dot_solve`` to 1e-8 relative (measured below 3e-13), ``apply_forward`` to
1e-10, the gradient to 1e-8 (measured 4e-11), the fused likelihood's value
and autograd gradient against ``jax.value_and_grad`` to 1e-6 (measured
7e-11). On the float64 1-D path the weak whitener's factors carry the ridge
floor of the skeleton solves (1e-9, ``tests/test_torch_hodlr.py``), which
changes the CG iterates: there CG runs to ``cg_tol=1e-13`` so that the
iterates do not see it. The far factors of 1-D data carry the same floor
(``tests/test_torch_hmatrix.py``), and a solve sees it through ``cond(K)``:
the log-determinant, ``dot_solve`` and the likelihood hold to 1e-8, the
solution vector to 1e-6 and the gradient to 1e-6. The dense-oracle
bounds are the JAX package's own (``tests/test_hmatrix.py``).
"""

import pickle
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import george_tpu as jgt
from george_tpu.solvers import hmatrix as JM
import george_tpu_torch as tgt
from george_tpu_torch.convert import kernel_from_reference
from george_tpu_torch.solvers import hmatrix as TM

torch.set_num_threads(2)

DEV = "cpu"   # the port's entry points default to the card
REL = 1e-8
REL_FWD = 1e-10
REL_FUSED = 1e-6


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _probes(seed, shape):
    return np.array(jax.random.rademacher(jax.random.PRNGKey(seed), shape,
                                          dtype=jnp.float64))


def _kernels(d, ell):
    kj = 1.0 * jgt.kernels.ExpSquaredKernel([ell] * d, ndim=d)
    kt = kernel_from_reference(
        1.0 * tgt.kernels.ExpSquaredKernel([1.0] * d, ndim=d),
        kj.get_parameter_names(), kj.get_parameter_vector())
    return kj, kt


class Pair(object):
    """A JAX and a port GP with ``HMatrixSolver(**kw)`` computed on the
    same data, the port on the JAX package's probes (and, on the float64
    1-D path, its whitener's pivots)."""

    def __init__(self, x, y, yerr, kj, kt, **kw):
        self.x, self.y, self.yerr = x, y, yerr
        self.gj = jgt.GP(kj, solver=JM.HMatrixSolver, **kw)
        self.gj.compute(x, yerr)
        sj = self.gj.solver
        seed, num = sj.seed, sj.num_probes
        extra = dict(probes=_probes(seed, (num, sj._hs.n_pad)),
                     grad_probes=_probes(seed + 1, (num, len(x))))
        if sj._st is not None and sj._st.L > 0:
            extra["pivots"] = [(np.array(lev["row_piv"]),
                                np.array(lev["col_piv"]))
                               for lev in sj._st.levels]
        self.gt = tgt.GP(kt, solver=TM.HMatrixSolver, device=DEV, **kw,
                         **extra)
        self.gt.compute(x, yerr)
        self.sj, self.st = sj, self.gt.solver


def _data_2d(n=1200, seed=0, span=10.0):
    """``tests/test_hmatrix.py::_setup``'s 2-D data."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, span, (n, 2))
    y = np.sin(x[:, 0]) + 0.1 * rng.standard_normal(n)
    return x, y, 0.1 * np.ones(n)


_PAIRS = {}


def _nystrom():
    """The 2-D rig of the JAX package's protocol test (n = 1200, min_size
    64, rank 16, precond_rank 64): the Nystrom whitener at the auto rank."""
    if "2d" not in _PAIRS:
        x, y, yerr = _data_2d()
        _PAIRS["2d"] = Pair(x, y, yerr, *_kernels(2, 1.5), min_size=64,
                            rank=16, precond_rank=64)
    return _PAIRS["2d"]


def _sym_1d():
    """Smooth 1-D data in float64: the weak symmetric HODLR whitener."""
    if "1d" not in _PAIRS:
        rng = np.random.default_rng(0)
        n = 1200
        x = rng.uniform(0, 30.0, (n, 1))
        y = np.sin(x[:, 0]) + 0.1 * rng.standard_normal(n)
        _PAIRS["1d"] = Pair(x, y, 0.1 * np.ones(n), *_kernels(1, 4.0),
                            cg_tol=1e-13)
    return _PAIRS["1d"]


# ---------------------------------------------------------------------------
# the Nystrom path (2-D)
# ---------------------------------------------------------------------------

def test_port_nystrom_solver_matches_reference_and_dense():
    p = _nystrom()
    sj, st = p.sj, p.st
    assert st._nystrom is not None and st._sym is None
    assert st.nystrom_rank_effective == sj.nystrom_rank_effective
    assert st.near_bytes <= st.store_near_budget and st._near is not None
    assert abs(st.log_determinant - sj.log_determinant) < REL * abs(
        sj.log_determinant)
    rng = np.random.default_rng(4)
    v = rng.standard_normal(len(p.x))
    V = rng.standard_normal((len(p.x), 3))
    assert _rel(st.apply_inverse(v), sj.apply_inverse(v)) < REL
    assert st.last_cg_iters == sj.last_cg_iters
    assert _rel(st.apply_inverse(V), sj.apply_inverse(V)) < REL
    assert abs(st.dot_solve(v) - sj.dot_solve(v)) < REL * abs(
        sj.dot_solve(v))
    # the dense oracle, at the JAX package's bounds
    Kd = p.gj.kernel.get_value(p.x) + np.diag(p.yerr ** 2)
    zref = np.linalg.solve(Kd, v)
    assert _rel(st.apply_inverse(v), zref) < 1e-4
    ld_ref = np.linalg.slogdet(Kd)[1]
    assert abs(st.log_determinant - ld_ref) / abs(ld_ref) < 1e-4


@pytest.mark.parametrize("i", [0, 1, 2, 3])
def test_port_apply_forward_matches_reference(i):
    """``(K + diag) v`` and ``dK/dtheta_{i-1} v`` (forward mode through the
    recompressing matvec), against the JAX package and the dense
    gradient."""
    p = _nystrom()
    v = np.random.default_rng(5).standard_normal(len(p.x))
    got = p.st.apply_forward(v, i)
    assert _rel(got, p.sj.apply_forward(v, i)) < REL_FWD
    if i:
        ref = p.gj.kernel.get_gradient(p.x)[:, :, i - 1] @ v
        assert np.abs(got - ref).max() / max(np.abs(ref).max(),
                                             1e-12) < 1e-5


@pytest.mark.parametrize("deflation", ["auto", 0])
def test_port_gradient_matches_reference(deflation):
    """The deflated Hutchinson gradient with its fitted control variate
    (``"auto"`` rank from the Nystrom spectrum), and the plain estimator
    (deflation off), on the JAX package's gradient probes."""
    p = _nystrom()
    # a plain attribute, read when the gradient is taken
    p.sj.grad_deflation_rank = p.st.grad_deflation_rank = deflation
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            gj = p.gj.grad_log_likelihood(p.y)
            gt = p.gt.grad_log_likelihood(p.y)
            r = p.st._grad_deflation_basis()
            rj = p.sj._grad_deflation_basis()
    finally:
        p.sj.grad_deflation_rank = p.st.grad_deflation_rank = "auto"
    assert _rel(gt, gj) < REL
    if deflation == "auto":
        assert r.shape[1] == rj.shape[1] > 64
        # and the dense gradient, at the JAX package's bound
        gb = jgt.GP(p.gj.kernel)
        gb.compute(p.x, p.yerr)
        g_ref = gb.grad_log_likelihood(p.y)
        assert np.abs(gt - g_ref).max() / np.abs(g_ref).max() < 0.1
    else:
        assert r is None and rj is None


def test_port_gradient_warns_when_rank_starved():
    """A Nystrom basis far below the kernel's effective rank leaves the
    deflation rank-starved: the port warns, as the JAX package does."""
    x, y, yerr = _data_2d(n=600)
    _, kt = _kernels(2, 1.5)
    gp = tgt.GP(kt, solver=TM.HMatrixSolver, num_probes=4,
                nystrom_rank=16, device=DEV)
    gp.compute(x, yerr)
    with pytest.warns(RuntimeWarning, match="rank-starved"):
        g = gp.grad_log_likelihood(y)
    assert np.all(np.isfinite(g))


def test_port_loglike_fn_matches_jax_grad():
    """The fused likelihood: value and autograd gradient in theta, the
    diagonal and the residual against ``jax.value_and_grad`` of the JAX
    package's ``loglike_fn``, at compute-theta and away from it (the
    frozen-whitener sandwich), on the same SLQ probes and adjoint block."""
    rng = np.random.default_rng(6)
    n = 900
    x = rng.uniform(0, 8, (n, 2))
    y = (np.sin(x[:, 0]) * np.cos(0.7 * x[:, 1])
         + 0.1 * rng.standard_normal(n))
    yerr = 0.2 * np.ones(n)
    kj, kt = _kernels(2, 1.2)
    p = Pair(x, y, yerr, kj, kt, min_size=32, rank=12, num_probes=24,
             num_steps=20)
    fj = jax.jit(jax.value_and_grad(p.sj.loglike_fn(), argnums=(0, 1, 2)))
    ft = p.st.loglike_fn()
    theta0 = np.asarray(kj.get_parameter_vector())
    for theta in (theta0, theta0 + np.array([0.15, -0.1, 0.1])):
        vj, gj = fj(jnp.asarray(theta), jnp.asarray(yerr ** 2),
                    jnp.asarray(y))
        args = [torch.tensor(a).requires_grad_(True)
                for a in (theta, yerr ** 2, y)]
        vt = ft(*args)
        gt = torch.autograd.grad(vt, args)
        assert abs(vt.item() - float(vj)) < REL_FUSED * abs(float(vj))
        for a, b in zip(gt, gj):
            assert _rel(a.numpy(), b) < REL_FUSED


def test_port_loglike_fn_on_the_fly_equals_stored():
    """Where the near field is not stored, the fused likelihood
    differentiates through the on-the-fly near field (its blocks evaluated
    again in the backward): the same value and gradient as through the
    stored one."""
    x, y, yerr = _data_2d(n=600, span=7.0)
    _, kt = _kernels(2, 1.5)
    vals = []
    for store in (True, False):
        s = TM.HMatrixSolver(kt, min_size=32, rank=12, store_near=store,
                             device=DEV)
        s.compute(x, yerr)
        assert (s._near is not None) == store
        args = [torch.tensor(a).requires_grad_(True)
                for a in (np.asarray(kt.parameter_vector), yerr ** 2, y)]
        v = s.loglike_fn()(*args)
        vals.append((v.item(), torch.autograd.grad(v, args)))
    (v1, g1), (v0, g0) = vals
    assert abs(v1 - v0) < 1e-10 * abs(v1)
    for a, b in zip(g0, g1):
        assert _rel(a.numpy(), b.numpy()) < 1e-8


# ---------------------------------------------------------------------------
# the float64 1-D path (the weak symmetric HODLR whitener)
# ---------------------------------------------------------------------------

def test_port_sym_whitener_path_matches_reference():
    p = _sym_1d()
    sj, st = p.sj, p.st
    assert st._sym is not None and st._nystrom is None
    assert st._st.L > 0
    assert abs(st.log_determinant - sj.log_determinant) < REL * abs(
        sj.log_determinant)
    rng = np.random.default_rng(8)
    v = rng.standard_normal(len(p.x))
    # the solution itself inherits the 1-D far factors' ridge floor
    # through cond(K) = 2e4 (measured 4.2e-8 apart, each 1.2e-6 from the
    # dense solve); the scalars below do not
    assert _rel(st.apply_inverse(v), sj.apply_inverse(v)) < 1e-6
    assert st.last_cg_iters == sj.last_cg_iters
    assert abs(st.dot_solve(v) - sj.dot_solve(v)) < REL * abs(
        sj.dot_solve(v))
    assert abs(p.gt.log_likelihood(p.y) - p.gj.log_likelihood(p.y)) < (
        REL * abs(p.gj.log_likelihood(p.y)))


def test_port_sym_whitener_gradient_matches_reference():
    """The 1-D deflation basis (a QR of 64 FPS kernel columns) spans the
    kernel's smooth subspace: the gradient against the JAX package's, and
    its trace noise collapses against the dense gradient (the JAX
    package's 1e-3 bound)."""
    p = _sym_1d()
    gt = p.gt.grad_log_likelihood(p.y)
    assert _rel(gt, p.gj.grad_log_likelihood(p.y)) < 1e-6
    gb = jgt.GP(p.gj.kernel)
    gb.compute(p.x, 0.1)
    g_ref = gb.grad_log_likelihood(p.y)
    assert np.abs(gt - g_ref).max() / np.abs(g_ref).max() < 1e-3


# ---------------------------------------------------------------------------
# the GP through the solver
# ---------------------------------------------------------------------------

def test_port_gp_predict_and_sample():
    p = _nystrom()
    assert abs(p.gt.log_likelihood(p.y) - p.gj.log_likelihood(p.y)) < (
        REL * abs(p.gj.log_likelihood(p.y)))
    t = np.random.default_rng(7).uniform(0, 10, (50, 2))
    mu_t, var_t = p.gt.predict(p.y, t, return_var=True)
    mu_j, var_j = p.gj.predict(p.y, t, return_var=True)
    assert _rel(mu_t, mu_j) < REL
    assert np.abs(var_t - var_j).max() < 1e-10
    np.random.seed(0)
    s = p.gt.sample(size=2)
    assert s.shape == (2, len(p.x)) and np.all(np.isfinite(s))
    # apply_sqrt applied twice is the compressed matvec (the JAX package's
    # 1e-5 of scale). Lanczos keeps one reorthogonalization, so until it
    # has converged rounding moves its result: 100 steps on this rig
    # (measured: 60 steps leave S S v 6e-5 from K v and the two packages
    # 7e-6 apart; 100 steps 4e-6 and 7e-7)
    v = np.random.default_rng(21).standard_normal(len(p.x))
    Sv = p.st.apply_sqrt(v, num_steps=100)
    assert _rel(Sv, p.sj.apply_sqrt(v, num_steps=100)) < 1e-6
    SSv = p.st.apply_sqrt(Sv, num_steps=100)
    Kv = p.st.apply_forward(v)
    assert np.abs(SSv - Kv).max() < 1e-5 * np.abs(Kv).max()


def test_port_log_prob_fn_over_chains_equals_unbatched():
    """``log_prob_fn`` over 2 chains under ``vmap(grad_and_value)``, the
    samplers' batched evaluator: each chain's value and gradient equal the
    unbatched call's (the Functions run the members one after another)."""
    x, y, yerr = _data_2d(n=500, span=7.0)
    _, kt = _kernels(2, 1.5)
    gp = tgt.GP(kt, solver=TM.HMatrixSolver, min_size=32, rank=12,
                device=DEV)
    gp.compute(x, yerr)
    f = gp.log_prob_fn(x, y, yerr, gate_prior=False)
    th = torch.tensor(gp.get_parameter_vector())
    thetas = torch.stack([th, th + torch.tensor([0.1, -0.05, 0.08])])
    g, v = torch.func.vmap(torch.func.grad_and_value(f))(thetas)
    for c in range(2):
        g1, v1 = torch.func.grad_and_value(f)(thetas[c])
        assert abs(float(v[c] - v1)) <= 1e-10 * abs(float(v1))
        assert _rel(g[c].numpy(), g1.numpy()) < 1e-10
    # at compute-theta the fused value is the host path's
    assert abs(float(v[0]) - gp.log_likelihood(y)) < 1e-8 * abs(float(v[0]))


def test_port_lcm_orders_on_sort_axes():
    """An ``LCMKernel`` (task id in the last column): the solver orders and
    partitions on the spatial axis only, as the JAX solver does, and the
    likelihood matches the JAX solver's and the dense one."""
    rng = np.random.default_rng(0)
    n_per, T, Q = 200, 2, 2
    xs = np.sort(rng.uniform(0, 30.0, n_per * T))
    x = np.column_stack([xs, np.tile(np.arange(T), n_per).astype(float)])
    logBK = np.log(rng.uniform(0.3, 1.5, 2 * T * Q))
    y = rng.standard_normal(n_per * T)
    yerr = 0.3 * np.ones(n_per * T)

    def lcm(pkg):
        return pkg.LCMKernel(logBK, children=[pkg.ExpSquaredKernel(2.0),
                                              pkg.Matern32Kernel(1.0)],
                             T=T, Q=Q, ndim=1)

    p = Pair(x, y, yerr, lcm(jgt.kernels), lcm(tgt.kernels), min_size=64,
             rank=24)
    assert np.array_equal(p.st._perm, p.sj._perm)
    assert np.array_equal(p.st._perm, np.argsort(xs, kind="stable"))
    lt, lj = p.gt.log_likelihood(y), p.gj.log_likelihood(y)
    assert abs(lt - lj) < REL * abs(lj)
    gb = tgt.GP(lcm(tgt.kernels), device=DEV)
    gb.compute(x, yerr)
    assert abs(lt - gb.log_likelihood(y)) < 1e-3 * abs(lt)


def test_port_solver_pickle_round_trip():
    """Pickling drops the device state: the restored GP recomputes and
    gives the same likelihood."""
    x, y, yerr = _data_2d(n=400, span=6.0)
    _, kt = _kernels(2, 1.5)
    gp = tgt.GP(kt, solver=TM.HMatrixSolver, min_size=32, rank=12,
                device=DEV)
    gp.compute(x, yerr)
    ll = gp.log_likelihood(y)
    state = pickle.loads(pickle.dumps(gp.solver)).__dict__
    assert state["computed"] is False
    assert not any(k in state for k in ("_far", "_near", "_xpad", "_hs"))
    gp2 = pickle.loads(pickle.dumps(gp))
    assert gp2.log_likelihood(y) == pytest.approx(ll, rel=1e-12)


def test_port_hmatrix_exported_and_defaults_to_cuda():
    assert tgt.HMatrixSolver is TM.HMatrixSolver
    assert tgt.solvers.HMatrixSolver is TM.HMatrixSolver
    _, kt = _kernels(2, 1.5)
    s = TM.HMatrixSolver(kt)
    assert s.device == torch.device("cuda") and s.dtype == torch.float64
