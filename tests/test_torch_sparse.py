# -*- coding: utf-8 -*-
"""The port's compact-support sparse path held against the JAX package's,
in float64 on the CPU (the recipes of ``tests/test_sparse.py``).

Both sides see the same data, kernel parameters
(``convert.kernel_from_reference``) and, for the stochastic pieces, the same
Rademacher probes: the JAX package draws them with
``jax.random.rademacher(PRNGKey(seed), (num_probes, n))`` (``PRNGKey(seed +
1)`` for the Hutchinson gradient), and the tests hand those arrays to the
port's ``probes=`` / ``grad_probes=``. With shared probes the estimators
are the same arithmetic, so the port is held to 1e-8 relative (measured
at or below 1e-10 on these rigs). The DIA apply on the CPU is the kernel's
plain version; the kernel itself is tested on the card
(``tests/test_torch_dia.py``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import george_tpu as jgt
from george_tpu.solvers import SparseSolver as JaxSparse
from george_tpu.solvers import sparse as JS
from george_tpu.solvers import banded as JB
import george_tpu_torch as tgt
from george_tpu_torch.convert import kernel_from_reference
from george_tpu_torch.ops import _build
from george_tpu_torch.ops import dia as tdia
from george_tpu_torch.solvers import sparse as TS
from george_tpu_torch.solvers import banded as TB

torch.set_num_threads(2)

DEV = "cpu"
SEED = 7


def _kernels(ndim=1, log_rc=np.log(3.0)):
    """The same Wendland-tapered ExpSquared in both packages."""
    metric = 2.0 if ndim == 1 else [1.0, 1.5]
    kj = jgt.kernels.WendlandC2Kernel(
        log_rc=log_rc, ndim=ndim,
        kernel_base=1.2 * jgt.kernels.ExpSquaredKernel(metric, ndim=ndim))
    kt = tgt.kernels.WendlandC2Kernel(
        ndim=ndim,
        kernel_base=1.0 * tgt.kernels.ExpSquaredKernel(
            [1.0] * ndim if ndim > 1 else 1.0, ndim=ndim))
    kernel_from_reference(kt, kj.get_parameter_names(),
                          kj.get_parameter_vector())
    return kj, kt


def _data(ndim, n, seed=0):
    rng = np.random.default_rng(seed)
    if ndim == 1:
        x = np.sort(rng.uniform(0, 40, n))[:, None]
    else:
        x = rng.uniform(0, 10, (n, ndim))
    y = np.sin(x[:, 0]) + 0.3 * rng.standard_normal(n)
    return x, y, 0.3 * np.ones(n)


def _probes(seed, n):
    return np.array(jax.random.rademacher(
        jax.random.PRNGKey(seed), (16, n), dtype=jnp.float64))


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


@pytest.fixture(scope="module", params=[1, 2], ids=["dia", "ell"])
def iterative(request):
    """JAX and port solvers with ``direct=False`` on sorted 1-D data (the
    DIA path) and on 2-D data (the ELL path), sharing the SLQ probes."""
    ndim = request.param
    n = 400 if ndim == 1 else 300
    x, y, yerr = _data(ndim, n)
    kj, kt = _kernels(ndim, np.log(3.0) if ndim == 1 else np.log(1.5))
    sj = JaxSparse(kj, direct=False, seed=SEED)
    sj.compute(x, yerr)
    st = tgt.SparseSolver(kt, direct=False, seed=SEED,
                          probes=_probes(SEED, n), device=DEV)
    st.compute(x, yerr)
    assert (st._dia_offsets is not None) == (ndim == 1)
    assert (sj._dia_offsets is not None) == (ndim == 1)
    return sj, st, x, y


def test_wendland_values_and_gradients_match():
    for ndim in (1, 2):
        kj, kt = _kernels(ndim)
        assert kt.get_parameter_names() == kj.get_parameter_names()
        assert kt.get_cutoff() == kj.get_cutoff()
        x, _, _ = _data(ndim, 60)
        x[1] = x[0]                     # a zero distance off the diagonal
        np.testing.assert_allclose(kt.get_value(x, device=DEV),
                                   kj.get_value(x),
                                   rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(kt.get_gradient(x, device=DEV),
                                   kj.get_gradient(x),
                                   rtol=1e-12, atol=1e-12)
        assert np.isfinite(kt.get_gradient(x, device=DEV)).all()


@pytest.mark.parametrize("ndim", [1, 2, 3])
def test_radius_neighbors_csr_matches(ndim):
    """Equal to the JAX function's CSR after a per-row sort."""
    from george_tpu.neighbors import radius_neighbors_csr as jax_csr

    x, _, _ = _data(ndim, 500)
    radius = {1: 0.7, 2: 0.9, 3: 2.0}[ndim]
    idx_j, ptr_j = jax_csr(x, radius)
    idx_t, ptr_t = tgt.neighbors.radius_neighbors_csr(x, radius)
    np.testing.assert_array_equal(ptr_t, ptr_j)
    idx_j = idx_j.copy()
    for i in range(len(x)):
        idx_j[ptr_j[i]:ptr_j[i + 1]].sort()
    np.testing.assert_array_equal(idx_t, idx_j)


def test_knn_matrix_to_csr_matches():
    from george_tpu.neighbors import knn_matrix_to_csr as jax_knn

    knn = np.random.default_rng(1).integers(-1, 200, (200, 9))
    for a, b in zip(tgt.neighbors.knn_matrix_to_csr(knn, 200),
                    jax_knn(knn, 200)):
        np.testing.assert_array_equal(a, b)


def test_banded_offsets_and_tables_match():
    x, _, _ = _data(1, 400)
    idx, ptr = tgt.neighbors.radius_neighbors_csr(x, 1.5)
    band_t, band_j = TS.banded_offsets(idx, ptr), JS.banded_offsets(idx, ptr)
    for a, b in zip(band_t, band_j):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(TS.banded_ell_tables(*band_t, len(x)),
                    JS.banded_ell_tables(*band_j, len(x))):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(TS.ell_from_csr(idx, ptr), JS.ell_from_csr(idx, ptr)):
        np.testing.assert_array_equal(a, b)
    # 2-D data is not banded
    x2, _, _ = _data(2, 300)
    assert TS.banded_offsets(*tgt.neighbors.radius_neighbors_csr(x2, 1.0)) \
        is None


def test_banded_offsets_rejects_duplicate_csr():
    """The JAX package's regression (``tests/test_sparse.py:265``): a CSR
    with duplicate indices passes max-min+1 == count but is not a band."""
    nbr_idx = np.array([0, 1, 1, 1, 3, 2, 3], dtype=np.int64)
    row_ptr = np.array([0, 2, 5, 7], dtype=np.int64)
    assert TS.banded_offsets(nbr_idx, row_ptr) is None
    assert JS.banded_offsets(nbr_idx, row_ptr) is None
    nbr_idx = np.array([0, 1, 1, 2, 3, 2, 3], dtype=np.int64)
    assert TS.banded_offsets(nbr_idx, row_ptr) is not None


def test_ell_values_apply_and_dia_match():
    x, _, _ = _data(1, 400)
    kj, kt = _kernels(1, np.log(1.5))
    idx, ptr = tgt.neighbors.radius_neighbors_csr(x, 1.5)
    offsets, lo, hi = TS.banded_offsets(idx, ptr)
    rng = np.random.default_rng(2)
    diag = rng.uniform(0.01, 0.02, len(x))
    Y = rng.standard_normal((len(x), 3))
    thj, xj = jnp.asarray(kj.parameter_vector), jnp.asarray(x)
    tht, xt = torch.as_tensor(kt.parameter_vector), torch.as_tensor(x)
    outs = []
    for nbr, mask in (TS.banded_ell_tables(offsets, lo, hi, len(x)),
                      TS.ell_from_csr(idx, ptr)):
        vj = JS.ell_values(kj.pair_fn, thj, xj, jnp.asarray(nbr),
                           jnp.asarray(mask))
        vt = TS.ell_values(kt.pair_fn, tht, xt,
                           torch.as_tensor(nbr.astype(np.int64)),
                           torch.as_tensor(mask))
        np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=1e-12,
                                   atol=1e-12)
        ej = np.asarray(JS.ell_apply(vj, jnp.asarray(nbr), jnp.asarray(diag),
                                     jnp.asarray(Y)))
        et = TS.ell_apply(vt, torch.as_tensor(nbr.astype(np.int64)),
                          torch.as_tensor(diag), torch.as_tensor(Y)).numpy()
        np.testing.assert_allclose(et, ej, rtol=1e-12, atol=1e-12)
        mt = TS.ell_matvec(kt.pair_fn, tht, xt,
                           torch.as_tensor(nbr.astype(np.int64)),
                           torch.as_tensor(mask), torch.as_tensor(diag),
                           torch.as_tensor(Y[:, 0])).numpy()
        np.testing.assert_allclose(mt, et[:, 0], rtol=1e-12, atol=1e-12)
        outs.append((vj, vt, et))
    vj, vt, _ = outs[0]
    dj = np.asarray(JS.dia_apply(vj, offsets, jnp.asarray(diag),
                                 jnp.asarray(Y)))
    dt = TS.dia_apply(vt, offsets, torch.as_tensor(diag),
                      torch.as_tensor(Y)).numpy()
    np.testing.assert_allclose(dt, dj, rtol=1e-12, atol=1e-12)
    # the band and the gather layouts are one operator
    np.testing.assert_allclose(dt, outs[1][2], rtol=1e-12, atol=1e-12)


def _band_operator(n=400):
    x, _, _ = _data(1, n)
    kj, kt = _kernels(1, np.log(1.5))
    idx, ptr = tgt.neighbors.radius_neighbors_csr(x, 1.5)
    offsets, lo, hi = TS.banded_offsets(idx, ptr)
    nbr, mask = TS.banded_ell_tables(offsets, lo, hi, n)
    diag = 0.01 * np.ones(n)
    vj = JS.ell_values(kj.pair_fn, jnp.asarray(kj.parameter_vector),
                       jnp.asarray(x), jnp.asarray(nbr), jnp.asarray(mask))
    vt = torch.as_tensor(np.array(vj))

    def mv_j(Y):
        return JS.dia_apply(vj, offsets, jnp.asarray(diag), Y)

    def mv_t(Y):
        return TS.dia_apply(vt, offsets, torch.as_tensor(diag), Y)

    pdiag = np.asarray(vj)[:, -offsets[0]] + diag
    return mv_j, mv_t, pdiag, n


def test_cg_solve_matches():
    mv_j, mv_t, pdiag, n = _band_operator()
    B = np.random.default_rng(3).standard_normal((n, 2))
    for b in (B[:, 0], B):
        xj, itj = JS.cg_solve(mv_j, jnp.asarray(b), jnp.asarray(pdiag),
                              tol=1e-10, maxiter=1000)
        xt, itt = TS.cg_solve(mv_t, torch.as_tensor(b),
                              torch.as_tensor(pdiag), tol=1e-10,
                              maxiter=1000)
        xj = np.asarray(xj)
        assert xt.shape == xj.shape
        assert np.linalg.norm(xt.numpy() - xj) <= 1e-8 * np.linalg.norm(xj)
        # at tol 1e-10 the float64 residual sits at its rounding floor, so
        # the step that first dips under the threshold moves with the
        # summation order (measured: port 321, JAX 322 and 331 in two runs
        # of this same test); the solutions agree to 1e-8 all the same
        assert abs(itt - int(itj)) <= 0.05 * int(itj) and 0 < itt < 1000
    # the cap binds
    _, it = TS.cg_solve(mv_t, torch.as_tensor(B), torch.as_tensor(pdiag),
                        tol=1e-30, maxiter=7)
    assert it == 7


def _per_iteration_cg(matvec, b, precond_diag, tol, maxiter, history=None):
    """The Jacobi-preconditioned CG loop as the port ran it before the
    stopping test stayed on the device: one host test before every
    iteration. ``history`` collects the largest ``||r||^2 / ||b||^2`` of
    every test."""
    squeeze = b.ndim == 1
    B = b[:, None] if squeeze else b
    Minv = (1.0 / precond_diag)[:, None]
    X = torch.zeros_like(B)
    R = B
    Z = Minv * R
    P = Z
    rz = torch.sum(R * Z, dim=0)
    b2 = torch.clamp_min(torch.sum(B * B, dim=0), torch.finfo(B.dtype).tiny)
    tol2 = tol * tol
    it = 0
    while it < maxiter:
        ratio = torch.sum(R * R, dim=0) / b2
        if history is not None:
            history.append(float(ratio.max()))
        if not bool(torch.any(ratio > tol2)):
            break
        AP = matvec(P)
        denom = torch.sum(P * AP, dim=0)
        alpha = rz / torch.where(denom > 0, denom, 1.0)
        X = X + alpha * P
        R = R - alpha * AP
        Z = Minv * R
        rz_new = torch.sum(R * Z, dim=0)
        P = Z + (rz_new / torch.where(rz > 0, rz, 1.0)) * P
        rz = rz_new
        it += 1
    return (X[:, 0] if squeeze else X), it


def _tol_stopping_at(history, multiple):
    """A tolerance at which the loop whose residual ``history`` is given
    stops at its first iteration count that is (``multiple``) or is not a
    multiple of 8, and the count: the geometric mean of that test's ratio
    and the smallest before it, so that no earlier test passes."""
    for k in range(1, len(history)):
        if (k % 8 == 0) == multiple and history[k] < min(history[:k]):
            return (history[k] * min(history[:k])) ** 0.25, k
    raise AssertionError("no such count in the history")


@pytest.fixture(scope="module")
def cg_rig():
    """The band operator, right-hand sides of 1 and 4 columns, and for
    each the tolerances at which the per-iteration loop converges at a
    multiple of 8 iterations and at a count that is not one."""
    _, mv_t, pdiag, n = _band_operator()
    B = torch.as_tensor(np.random.default_rng(5).standard_normal((n, 4)))
    pd = torch.as_tensor(pdiag)
    rhs = {1: B[:, 0], 4: B}
    tols = {}
    for r, b in rhs.items():
        history = []
        _per_iteration_cg(mv_t, b, pd, 1e-30, 2000, history)
        for multiple in (True, False):
            tols[r, multiple] = _tol_stopping_at(history, multiple)
    return mv_t, pd, rhs, tols


@pytest.mark.parametrize("case", ["converged_at_8k", "converged_off_8k",
                                  "zero_b", "cap7", "cap8", "cap9"])
@pytest.mark.parametrize("r", [1, 4], ids=["vector", "block"])
def test_cg_solve_is_the_per_iteration_loop(cg_rig, r, case, monkeypatch):
    """``cg_solve`` on CPU tensors (the plain step, the test read every
    ``CG_READ_EVERY`` steps) gives the per-iteration loop's solution bit
    for bit and its iteration count, with ``ceil(iterations / 8) + 1``
    host reads and no kernel step."""
    from george_tpu_torch import diagnostics
    from george_tpu_torch.ops import cg as tcg

    mv_t, pd, rhs, tols = cg_rig
    b, tol, maxiter = rhs[r], 1e-30, 1000
    if case.startswith("converged"):
        tol, expected = tols[r, case == "converged_at_8k"]
        assert (expected % 8 == 0) == (case == "converged_at_8k")
    elif case == "zero_b":
        b, expected = torch.zeros_like(b), 0
    else:
        maxiter = expected = int(case[3:])
    monkeypatch.setattr(tcg, "cg_device_steps", 0)
    x_ref, it_ref = _per_iteration_cg(mv_t, b, pd, tol, maxiter)
    count, reads = TS.cg_iteration_count, diagnostics.host_reads
    x, it = TS.cg_solve(mv_t, b, pd, tol=tol, maxiter=maxiter)
    assert it_ref == expected and it == it_ref
    assert x.shape == b.shape and torch.equal(x, x_ref)
    assert TS.cg_iteration_count - count == it
    assert diagnostics.host_reads - reads == -(-it // TS.CG_READ_EVERY) + 1
    assert tcg.cg_device_steps == 0


def test_other_cg_loops_take_no_step(cg_rig, monkeypatch):
    """``pcg_solve`` with a callable preconditioner (the H-matrix solver's)
    and ``cg_solve`` on row-sharded vectors (``rowsum`` given) run the
    per-iteration loop: one host read a test, no CG step, none on the
    card; the Jacobi ``cg_solve`` takes the step."""
    from george_tpu_torch import diagnostics
    from george_tpu_torch.ops import cg as tcg

    mv_t, pd, rhs, _ = cg_rig
    b = rhs[4]
    steps = []

    def counted(*args, **kw):
        steps.append(1)
        return tcg.cg_step(*args, **kw)

    monkeypatch.setattr(TS, "cg_step", counted)
    monkeypatch.setattr(tcg, "cg_device_steps", 0)
    x_ref, it_ref = _per_iteration_cg(mv_t, b, pd, 1e-8, 1000)
    Minv = (1.0 / pd)[:, None]
    for solve in (
            lambda: TS.pcg_solve(mv_t, lambda R: Minv * R, b, tol=1e-8,
                                 maxiter=1000),
            lambda: TS.cg_solve(mv_t, b, pd, tol=1e-8, maxiter=1000,
                                rowsum=lambda t: t)):
        reads = diagnostics.host_reads
        x, it = solve()
        assert it == it_ref and torch.equal(x, x_ref)
        assert diagnostics.host_reads - reads == it + 1
    assert steps == [] and tcg.cg_device_steps == 0
    x, it = TS.cg_solve(mv_t, b, pd, tol=1e-8, maxiter=1000)
    assert it == it_ref and torch.equal(x, x_ref)
    assert len(steps) == -(-it // TS.CG_READ_EVERY) * TS.CG_READ_EVERY
    assert tcg.cg_device_steps == 0


def test_slq_logdet_and_lanczos_match():
    mv_j, mv_t, _, n = _band_operator()
    key = jax.random.PRNGKey(SEED)
    ld_j, sd_j = JS.slq_logdet(mv_j, n, jnp.float64, key, num_probes=16,
                               num_steps=30, return_std=True)
    ld_t, sd_t = TS.slq_logdet(mv_t, torch.as_tensor(_probes(SEED, n)),
                               num_steps=30, return_std=True)
    assert abs(float(ld_t) / float(ld_j) - 1) < 1e-8
    assert abs(float(sd_t) / float(sd_j) - 1) < 1e-8
    assert float(TS.slq_logdet(mv_t, torch.as_tensor(_probes(SEED, n)),
                               num_steps=30)) == float(ld_t)

    # at the solver's 30 steps: measured 3.5e-11. With one round of
    # reorthogonalization the basis loses orthogonality as the steps grow
    # on this kappa ~ 1e4 operator, and the two summation orders part:
    # 1.8e-14 at 20 steps, 3.7e-6 at 40
    B = np.random.default_rng(4).standard_normal((n, 3))
    ref = np.stack([np.asarray(JS.lanczos_fn_matvec(
        mv_j, jnp.asarray(B[:, k]), jnp.sqrt, num_steps=30))
        for k in range(3)], axis=1)
    out = TS.lanczos_fn_matvec(mv_t, torch.as_tensor(B), torch.sqrt,
                               num_steps=30).numpy()
    assert _rel(out, ref) < 1e-8
    one = TS.lanczos_fn_matvec(mv_t, torch.as_tensor(B[:, 1]), torch.sqrt,
                               num_steps=30).numpy()
    assert _rel(one, ref[:, 1]) < 1e-8


def test_iterative_solver_matches(iterative):
    """``direct=False``: SLQ log-determinant (shared probes), CG solves,
    exact matvecs and their theta derivatives, Lanczos square root."""
    sj, st, x, y = iterative
    n = len(x)
    assert st.nnz == sj.nnz
    assert abs(st.log_determinant / sj.log_determinant - 1) < 1e-8
    assert _rel(st.apply_inverse(y), sj.apply_inverse(y)) < 1e-8
    assert 0 < st.cg_iterations < st.maxiter
    assert abs(st.dot_solve(y) / sj.dot_solve(y) - 1) < 1e-8
    Y2 = np.stack([y, 2 * y + 1], axis=1)
    assert _rel(st.apply_inverse(Y2), sj.apply_inverse(Y2)) < 1e-8
    v = np.random.default_rng(1).standard_normal(n)
    for i in range(st._theta.shape[0] + 1):
        assert _rel(st.apply_forward(v, i),
                    np.asarray(sj.apply_forward(v, i))) < 1e-12
    R = np.random.default_rng(2).standard_normal((3, n))
    assert _rel(st.apply_sqrt(R), np.asarray(sj.apply_sqrt(R))) < 1e-8
    assert _rel(st.apply_sqrt(R[0]), np.asarray(sj.apply_sqrt(R[0]))) < 1e-8
    # the Hutchinson gradient on the same alpha, with the JAX package's
    # gradient probes (PRNGKey(seed + 1)) handed to the port
    alpha = np.asarray(sj.apply_inverse(y))
    st.grad_probes = _probes(SEED + 1, n)
    g_t = st.grad_log_likelihood(tgt.GP(st.kernel, device=DEV), x, alpha,
                                 None)
    g_j = sj.grad_log_likelihood(jgt.GP(sj.kernel), x, alpha, None)
    assert g_t.shape == g_j.shape == (st._theta.shape[0],)
    assert _rel(g_t, g_j) < 1e-8


def test_iterative_solver_draws_its_own_probes(iterative):
    """Without ``probes=`` the port draws Rademacher probes from a
    ``torch.Generator`` seeded with ``seed``: another stream than JAX's,
    so only the estimator's accuracy is shared (the 3% of
    ``tests/test_sparse.py:63``), and the draw repeats exactly."""
    sj, st, x, y = iterative
    own = tgt.SparseSolver(st.kernel, direct=False, seed=SEED, device=DEV)
    own.compute(x, 0.3)
    again = tgt.SparseSolver(st.kernel, direct=False, seed=SEED, device=DEV)
    again.compute(x, 0.3)
    assert own.log_determinant == again.log_determinant
    assert abs(own.log_determinant / sj.log_determinant - 1) < 0.03
    assert own.log_determinant_std > 0
    with pytest.raises(ValueError):
        tgt.SparseSolver(st.kernel, direct=False, probes=np.ones((3, 5)),
                         device=DEV).compute(x, 0.3)


def _direct_pair(n=500):
    """The recipe of ``tests/test_sparse.py::test_sparse_direct_banded``."""
    rng = np.random.default_rng(21)
    x = np.sort(rng.uniform(0, 25, n))
    y = np.sin(x) + 0.1 * rng.standard_normal(n)
    kj = jgt.kernels.WendlandC2Kernel(
        log_rc=np.log(1.5), kernel_base=jgt.kernels.ExpSquaredKernel(1.0))
    kt = tgt.kernels.WendlandC2Kernel(
        kernel_base=tgt.kernels.ExpSquaredKernel(1.0))
    kernel_from_reference(kt, kj.get_parameter_names(),
                          kj.get_parameter_vector())
    sj = JaxSparse(kj)
    sj.compute(x, 0.1)
    st = tgt.SparseSolver(kt, device=DEV)
    st.compute(x, 0.1)
    assert sj._direct_loglike is not None and st._band_factors is not None
    return sj, st, x, y


@pytest.fixture(scope="module")
def direct():
    return _direct_pair()


def test_banded_blocks_and_factors_match(direct):
    sj, st, x, y = direct
    offsets = st._dia_offsets
    b = st._block_size
    vals = st._vals
    diag = st._diag
    Aj, Bj = JB.band_blocks(jnp.asarray(vals.numpy()), offsets,
                            jnp.asarray(diag.numpy()), b)
    At, Bt = TB.band_blocks(vals, offsets, diag, b)
    np.testing.assert_array_equal(At.numpy(), np.asarray(Aj))
    np.testing.assert_array_equal(Bt.numpy(), np.asarray(Bj))
    Lj, Cj, ldj = JB.banded_cholesky(Aj, Bj)
    Lt, Ct, ldt = TB.banded_cholesky(At, Bt)
    assert _rel(Lt.numpy(), Lj) < 1e-12 and _rel(Ct.numpy(), Cj) < 1e-12
    assert abs(float(ldt) / float(ldj) - 1) < 1e-12
    assert abs(st.log_determinant / sj.log_determinant - 1) < 1e-12
    Y = np.random.default_rng(5).standard_normal((len(x), 2))
    for rhs in (Y[:, 0], Y):
        assert _rel(TB.banded_solve(Lt, Ct, torch.as_tensor(rhs)).numpy(),
                    JB.banded_solve(Lj, Cj, jnp.asarray(rhs))) < 1e-10
        assert _rel(TB.banded_sqrt_matvec(Lt, Ct, torch.as_tensor(rhs))
                    .numpy(),
                    JB.banded_sqrt_matvec(Lj, Cj, jnp.asarray(rhs))) < 1e-12
    assert _rel(st.apply_inverse(y), sj.apply_inverse(y)) < 1e-10
    R = np.random.default_rng(6).standard_normal((2, len(x)))
    assert _rel(st.apply_sqrt(R), np.asarray(sj.apply_sqrt(R))) < 1e-12


def test_banded_fused_loglike_and_gradient_match(direct):
    """The fused exact likelihood (JAX ``_direct_loglike``) to 1e-10 and
    its autograd gradient in theta and the diagonal (JAX ``_direct_grad``)
    to 1e-8."""
    sj, st, x, y = direct
    r = np.asarray(y, dtype=np.float64)
    diag = 0.01 * np.ones(len(x))
    th = st._theta.clone().requires_grad_(True)
    dg = torch.as_tensor(diag).requires_grad_(True)
    ll_t = st.loglike_fn()(th, dg, torch.as_tensor(r))
    g_t = torch.autograd.grad(ll_t, (th, dg))
    th_j = jnp.asarray(sj._theta)
    ll_j = sj._direct_loglike(th_j, jnp.asarray(diag), jnp.asarray(r))
    g_j = sj._direct_grad(th_j, jnp.asarray(diag), jnp.asarray(r))
    assert abs(float(ll_t.detach()) / float(ll_j) - 1) < 1e-10
    for a, b in zip(g_t, g_j):
        assert _rel(a.numpy(), np.asarray(b)) < 1e-8


def test_banded_failure_gives_nan(direct):
    """A matrix that is not positive definite only in its last block step
    gives a NaN log-determinant and likelihood, as the JAX package's
    NaN-filled factor gives a non-finite one."""
    sj, st, x, y = direct
    offsets, b = st._dia_offsets, st._block_size
    diag = 0.01 * np.ones(len(x))
    diag[-3] = -10.0                    # a negative pivot in the last block
    A, Bs = TB.band_blocks(st._vals, offsets, torch.as_tensor(diag), b)
    assert torch.isnan(TB.banded_cholesky(A, Bs)[2])
    Aj, Bj = JB.band_blocks(jnp.asarray(st._vals.numpy()), offsets,
                            jnp.asarray(diag), b)
    assert not np.isfinite(float(JB.banded_cholesky(Aj, Bj)[2]))
    ll = st.loglike_fn()(st._theta, torch.as_tensor(diag), torch.as_tensor(y))
    assert torch.isnan(ll)


def test_solver_options_and_refusals():
    x2, _, _ = _data(2, 64)
    _, k2 = _kernels(2, np.log(2.0))
    with pytest.raises(ValueError):
        tgt.SparseSolver(k2, direct=True, device=DEV).compute(x2, 0.1)
    with pytest.raises(ValueError):
        tgt.SparseSolver(k2, direct="yes", device=DEV)
    with pytest.raises(TypeError):     # a mesh is a DeviceMesh
        tgt.SparseSolver(k2, mesh=object(), device=DEV)
    s = tgt.SparseSolver(k2, device=DEV)
    s.compute(x2, 0.3)                  # not banded: "auto" goes iterative
    assert s._dia_offsets is None and s._band_factors is None
    # the iterative path's fused likelihood (CG and SLQ with their
    # adjoints, through the gather apply here) is the solver's likelihood
    y2 = np.sin(x2[:, 0])
    ll = s.loglike_fn()(s._theta, s._diag, torch.as_tensor(y2))
    assert float(ll) == pytest.approx(
        -0.5 * (s.dot_solve(y2) + s.log_determinant
                + 64 * np.log(2 * np.pi)), rel=1e-8)
    Kinv = s.get_inverse()
    assert Kinv.shape == (64, 64)
    K = k2.get_value(x2, device=DEV) + 0.09 * np.eye(64)
    assert np.allclose(Kinv @ K, np.eye(64), atol=1e-6)
    state = s.__getstate__()
    assert not state["computed"] and "_vals" not in state


def test_cpu_path_never_builds(monkeypatch):
    def refuse():
        raise AssertionError("the CPU path must not build the kernels")

    monkeypatch.setattr(_build, "build", refuse)
    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(tdia, "dia_kernel_launches", 0)
    x, y, yerr = _data(1, 150)
    _, kt = _kernels(1)
    gp = tgt.GP(kt, solver=tgt.SparseSolver, direct=False, device=DEV,
                dtype=torch.float32)
    gp.compute(x, yerr)
    assert np.isfinite(gp.log_likelihood(y))
    assert np.isfinite(gp.grad_log_likelihood(y)).all()
    assert gp.solver._vals.dtype == torch.float32
    assert tdia.dia_kernel_launches == 0


def test_fused_loglike_spans_and_counters(monkeypatch):
    """One value + gradient of ``GP.log_prob_fn`` on the iterative path:
    the spans ``sparse.cg`` (the value's solve and the two its adjoints
    call), ``sparse.slq`` and ``sparse.adjoint`` (the two backwards);
    ``cg_iteration_count`` grows by the iterations the solves report and
    ``diagnostics.host_reads`` by the reads of their stopping tests, one
    before the first step and one every ``CG_READ_EVERY`` steps up to the
    stop; no CG step ran on a card; value and gradient bit-identical with
    the profiler on and off."""
    from torch.profiler import ProfilerActivity, profile
    from george_tpu_torch import diagnostics
    from george_tpu_torch.ops import cg as tcg

    x, y, yerr = _data(1, 300)
    _, kt = _kernels(1)
    gp = tgt.GP(kt, solver=tgt.SparseSolver, direct=False, seed=SEED,
                device=DEV, dtype=torch.float64)
    gp.compute(x, yerr)
    f = torch.func.grad_and_value(gp.log_prob_fn(x, y, yerr))
    th = torch.as_tensor(gp.get_parameter_vector())
    g0, v0 = f(th)
    iters, solve = [], TS.cg_solve

    def recorded(*args, **kw):
        out = solve(*args, **kw)
        iters.append(out[1])
        return out

    monkeypatch.setattr(TS, "cg_solve", recorded)
    monkeypatch.setattr(tcg, "cg_device_steps", 0)
    count, reads = TS.cg_iteration_count, diagnostics.host_reads
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        g1, v1 = f(th)
    assert torch.equal(g0, g1) and torch.equal(v0, v1)
    names = [e.name for e in prof.events()]
    assert [names.count(n) for n in ("sparse.cg", "sparse.slq",
                                     "sparse.adjoint")] == [3, 1, 2]
    assert len(iters) == 3 and 0 < max(iters) < gp.solver.maxiter
    assert TS.cg_iteration_count - count == sum(iters)
    assert diagnostics.host_reads - reads == sum(
        -(-i // TS.CG_READ_EVERY) + 1 for i in iters)
    assert tcg.cg_device_steps == 0
    # the protocol's solves count on the same counter
    count = TS.cg_iteration_count
    gp.solver.apply_inverse(y)
    assert TS.cg_iteration_count - count == gp.solver.cg_iterations > 0
