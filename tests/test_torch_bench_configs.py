# -*- coding: utf-8 -*-
"""bench.py's other configurations, held against the JAX package on the
CPU in float64 at the structure they use.

``chip_smoke.py`` phase 19 drives the port on the card at bench.py's
smooth n = 1e6 (``min_size`` 256: 11 levels, rank 12, the Hutchinson
gradient with one refinement step, float32) and quasi-periodic (qp) n = 1e5
(rank 48), and at ``BASELINE.md`` row 3. Here, at small sizes:

* chip_smoke's datasets are bench.py's ``_dataset``, bit for bit;
* a depth-11 rig (bench's smooth kernel on [0, 1000], 2048 leaves of 12
  points, rank 12, the JAX ACA pivots carried over): the Hutchinson
  likelihood and gradient with 8 shared probes and one refinement step in
  float64 against the JAX package (measured 1.0e-10 in the likelihood,
  1.3e-7 of max|g|), and the float32 errors from float64 no worse than the
  JAX package's by more than 2x (measured: ll 1.6e-7 port / 1.58e-3 JAX,
  gradient 8.1e-6 / 4.2e-2 of max|g|; the port's float32 solver runs its
  SMW cascade in float64, ``hodlr._CASCADE``);
* a qp rig at rank 48 (n = 4000 on [0, 40], bench's 100 points a unit,
  16 leaves of 250): factor, solve, likelihood and Hutchinson gradient on
  shared pivots and probes at ``tests/test_torch_hodlr.py``'s tolerances
  where rank 48 lets them hold (each test says where it does not, and
  why), and the port's ``GP`` against the JAX package's, each with its own
  ACA walk;
* ``BASELINE.md`` row 3 at n = 2500 on [0, 25] (``tests/test_golden.py``'s
  density): HODLR at rank 64 against the port's dense solver and the JAX
  HODLR, relative 1e-6;
* the chunked leaf and skeleton assembly (``hodlr._CHUNK_BYTES``) gives the
  unchunked factors bit for bit, with one leaf-kernel call.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from george_tpu import GP as JGP
from george_tpu import HODLRSolver as JHODLRSolver
from george_tpu import kernels as jk
from george_tpu.solvers import hodlr as JH
import george_tpu_torch as tgt
from george_tpu_torch import convert
from george_tpu_torch import kernels as tk
from george_tpu_torch.solvers import hodlr as TH

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import bench  # noqa: E402
import chip_smoke  # noqa: E402

torch.set_num_threads(2)

DEV = "cpu"
SHARED = 1e-10      # same inputs, summation order only
SKELETON = 1e-8     # through each package's own ridge-solved skeletons
PROBES = 8


def _t(a, dtype=torch.float64):
    a = np.asarray(a)
    return torch.as_tensor(a) if a.dtype == bool else torch.as_tensor(
        a, dtype=dtype)


def _rel(a, b):
    return abs(float(a) - float(b)) / abs(float(b))


def _smooth_kernels():
    return (1.2 * jk.ExpSquaredKernel(25.0) + 0.3 * jk.Matern32Kernel(8.0),
            1.2 * tk.ExpSquaredKernel(25.0) + 0.3 * tk.Matern32Kernel(8.0))


def _qp_kernels():
    return (1.0 * jk.ExpSquaredKernel(20.0) * jk.ExpSine2Kernel(
        gamma=1.0, log_period=np.log(3.7)), chip_smoke.qp_kernel())


@pytest.mark.parametrize("variant,n", [("smooth", 100_000),
                                       ("smooth", 1_000_000),
                                       ("qp", 100_000), ("qp", 1_000_000)])
def test_chip_smoke_datasets_are_bench_datasets(variant, n):
    kj, xj, yj, yerr2, _ = bench._dataset(variant, n, np.float64)
    x, y, yerr, kt = chip_smoke.DATASETS[variant](n)
    np.testing.assert_array_equal(x, xj)
    np.testing.assert_array_equal(y, yj)
    np.testing.assert_array_equal(yerr ** 2, yerr2)
    assert tuple(kt.get_parameter_names()) == tuple(kj.get_parameter_names())
    np.testing.assert_array_equal(kt.get_parameter_vector(),
                                  np.asarray(kj.get_parameter_vector()))


class Rig(object):
    """One dataset, the JAX transposed structure with its ACA pivots, the
    port's structure on the same pivots, and the padded inputs."""

    def __init__(self, x, y, noise2, kernels, min_size, rank):
        self.kj, self.kt = kernels
        n = len(x)
        st = JH.build_structure(n, min_size=min_size, rank=rank, seed=42,
                                x_sorted=x)
        st.transposed = True
        self.n, self.st = n, st
        self.theta = np.asarray(self.kj.parameter_vector)
        self.xpad = np.concatenate([x, np.repeat(x[-1:], st.n_pad - n, 0)])
        self.valid = np.zeros(st.n_pad, bool)
        self.valid[:n] = True
        JH.select_aca_pivots(self.kj.pair_fn, self.theta, self.xpad,
                             self.valid, st)
        self.stt = convert.structure_from_arrays(
            n, min_size, rank, 42,
            [(lev["row_piv"], lev["col_piv"]) for lev in st.levels])
        self.dp = np.ones(st.n_pad)
        self.dp[:n] = noise2
        self.y = np.zeros(st.n_pad)
        self.y[:n] = y
        key = jax.random.PRNGKey(0)
        self.key = key
        self.probes = np.array(jax.random.rademacher(
            key, (PROBES, st.n_pad), dtype=jnp.float64))

    def jax_hutchinson(self, dtype):
        pair, st, n = self.kj.pair_fn, self.st, self.n
        args = [jnp.asarray(a, dtype=dtype) for a in
                (self.theta, self.xpad)] + [jnp.asarray(self.valid)] + [
                    jnp.asarray(a, dtype=dtype) for a in (self.dp, self.y)]
        ll, g = jax.jit(
            lambda th, *a: JH.hodlr_loglike_and_grad_hutchinson(
                pair, th, *a, st, self.key, num_probes=PROBES, n_real=n,
                refine_steps=1))(*args)
        return float(ll), np.asarray(g, dtype=np.float64)

    def port_args(self, dtype):
        return (self.kt.pair_fn, _t(self.theta, dtype), _t(self.xpad, dtype),
                _t(self.valid), _t(self.dp, dtype))

    def port_hutchinson(self, dtype):
        ll, g = TH.hodlr_loglike_and_grad_hutchinson(
            *self.port_args(dtype), _t(self.y, dtype), self.stt,
            num_probes=PROBES, n_real=self.n, refine_steps=1,
            probes=self.probes)
        return float(ll), g.double().numpy()


@pytest.fixture(scope="module")
def deep_rig():
    """Depth 11: bench's smooth kernel on [0, 1000], 2048 leaves of 12."""
    rng = np.random.default_rng(42)
    n = 2048 * 12
    x = np.sort(rng.uniform(0, 1000.0, n))[:, None]
    y = np.sin(0.1 * x[:, 0]) + 0.3 * rng.standard_normal(n)
    rig = Rig(x, y, 0.09, _smooth_kernels(), min_size=12, rank=12)
    assert (rig.st.L, rig.st.m) == (11, 12)
    rig.results = {}
    for side in ("jax", "port"):
        for dt in ("float64", "float32"):
            fn = rig.jax_hutchinson if side == "jax" else rig.port_hutchinson
            rig.results[side, dt] = fn(getattr(
                jnp if side == "jax" else torch, dt))
    return rig


def test_depth11_hutchinson_f64_matches_reference(deep_rig):
    lj, gj = deep_rig.results["jax", "float64"]
    lt, gt = deep_rig.results["port", "float64"]
    assert _rel(lt, lj) < 1e-9
    assert np.abs(gt - gj).max() <= 1e-6 * np.abs(gj).max()


def test_depth11_hutchinson_f32_no_worse_than_reference(deep_rig):
    """Each package's float32 likelihood and gradient measured from its
    own float64 values on the same pivots and probes: the port's errors
    at most 2x the JAX package's, so the float32 cascade at this depth
    loses no more in the port than in the reference."""
    r = deep_rig.results
    errs = {}
    for side in ("jax", "port"):
        l64, g64 = r[side, "float64"]
        l32, g32 = r[side, "float32"]
        assert np.isfinite(l32) and np.all(np.isfinite(g32))
        errs[side] = (_rel(l32, l64),
                      np.abs(g32 - g64).max() / np.abs(g64).max())
    assert errs["port"][0] <= 2.0 * errs["jax"][0]
    assert errs["port"][1] <= 2.0 * errs["jax"][1]


@pytest.fixture(scope="module")
def qp_rig():
    """bench's qp data and kernel at 100 points a unit: n = 4000 on
    [0, 40], 16 leaves of 250, rank 48."""
    rng = np.random.default_rng(42)
    n = 4000
    x = np.sort(rng.uniform(0, 40.0, n))[:, None]
    y = (np.sin(2 * np.pi * x[:, 0] / 3.7) * np.cos(0.13 * x[:, 0])
         + 0.25 * rng.standard_normal(n))
    rig = Rig(x, y, 0.0625, _qp_kernels(), min_size=128, rank=48)
    assert (rig.st.L, rig.st.m, rig.st.rank) == (4, 250, 48)
    rig.x, rig.yraw = x, y
    pair = rig.kj.pair_fn
    st = rig.st
    rig.fj, rig.ldj = jax.jit(
        lambda th, *a: JH.hodlr_factor(pair, th, *a, st)
    )(*[jnp.asarray(a) for a in (rig.theta, rig.xpad, rig.valid, rig.dp)])
    _, rig.ldt = TH.hodlr_factor(*rig.port_args(torch.float64), rig.stt)
    return rig


def _as_torch(factors):
    return {"Lleaf": _t(factors["Lleaf"]),
            "levels": [tuple(_t(a) for a in lev)
                       for lev in factors["levels"]]}


def test_qp_rank48_factor_and_solve_match_reference(qp_rig):
    """The log-determinant and the compressed operator through each
    package's own skeletons (measured 4.0e-10 and 5.6e-9), and the solve
    code on one shared set of factors (measured 7.8e-13)."""
    r = qp_rig
    assert _rel(r.ldt, r.ldj) < SKELETON
    V = np.random.default_rng(1).standard_normal((r.st.n_pad, 3))
    jargs = [jnp.asarray(a) for a in (r.theta, r.xpad, r.valid, r.dp)]
    mj = np.asarray(jax.jit(
        lambda th, xp, v, d, X: JH.hodlr_matvec(r.kj.pair_fn, th, xp, v, d,
                                                r.st, X))(*jargs,
                                                          jnp.asarray(V)))
    mt = TH.hodlr_matvec(*r.port_args(torch.float64), r.stt, _t(V)).numpy()
    assert np.linalg.norm(mt - mj) / np.linalg.norm(mj) < SKELETON
    zj = np.asarray(jax.jit(lambda f, b: JH.hodlr_solve(f, r.st, b))(
        r.fj, jnp.asarray(r.y)))
    zt = TH.hodlr_solve(_as_torch(r.fj), r.stt, _t(r.y)).numpy()
    assert np.linalg.norm(zt - zj) / np.linalg.norm(zj) < SHARED


def test_qp_rank48_hutchinson_matches_reference(qp_rig):
    """Both packages on the JAX factors and the same probes: the
    likelihood (measured 1.2e-13) at SHARED. The gradient's dK pass
    differentiates each package's own ridge-solved interpolants, and at
    rank 48, above the qp blocks' numerical rank (~35), their components
    at the ridge floor are set by rounding (the two packages' skeleton
    factors differ by 5-10% while their products agree to 5.6e-9): it is
    held to 1e-3 of max|g| (measured 5.0e-5)."""
    r = qp_rig
    pair = r.kj.pair_fn
    jargs = [jnp.asarray(a) for a in (r.theta, r.xpad, r.valid, r.dp,
                                      r.y)]
    lj, gj = jax.jit(
        lambda th, xp, v, d, yy, f, ld: JH.hodlr_loglike_and_grad_hutchinson(
            pair, th, xp, v, d, yy, r.st, r.key, num_probes=PROBES,
            n_real=r.n, refine_steps=1, factors_logdet=(f, ld)))(
                *jargs, r.fj, r.ldj)
    lt, gt = TH.hodlr_loglike_and_grad_hutchinson(
        *r.port_args(torch.float64), _t(r.y), r.stt, num_probes=PROBES,
        n_real=r.n, refine_steps=1, probes=r.probes,
        factors_logdet=(_as_torch(r.fj), _t(r.ldj)))
    assert _rel(lt, lj) < SHARED
    gj = np.asarray(gj)
    assert np.abs(gt.numpy() - gj).max() <= 1e-3 * np.abs(gj).max()


def test_qp_rank48_gp_matches_reference_gp(qp_rig):
    """Each package's ``GP`` with its own host ACA walk (the walks may
    break near-ties differently) and its own skeletons: the likelihoods
    within 1e-7 of its largest term, ``|log det K|`` (the likelihood
    itself, -275, is a difference of terms of 1e4)."""
    r = qp_rig
    yerr = 0.25 * np.ones(r.n)
    gj = JGP(_qp_kernels()[0], solver=JHODLRSolver, min_size=128, rank=48,
             seed=42)
    gj.compute(r.x, yerr)
    gt = tgt.GP(chip_smoke.qp_kernel(), solver=tgt.HODLRSolver,
                min_size=128, rank=48, seed=42, device=DEV)
    gt.compute(r.x, yerr)
    d = abs(gt.log_likelihood(r.yraw) - gj.log_likelihood(r.yraw))
    assert d < 1e-7 * abs(float(r.ldj))


def test_baseline_row3_at_golden_density():
    """``tests/test_golden.py``'s quasi-periodic data (100 points a unit)
    at n = 2500: HODLR rank 64 against the port's dense solver and the
    JAX HODLR."""
    rng = np.random.default_rng(42)
    n = 2500
    x = np.sort(rng.uniform(0, 25.0, n))[:, None]
    yerr = 0.25 * np.ones(n)
    y = (np.sin(2 * np.pi * x[:, 0] / 3.7) * np.cos(0.13 * x[:, 0])
         + 0.25 * rng.standard_normal(n))
    kj, _ = _qp_kernels()
    gh = tgt.GP(chip_smoke.qp_kernel(), solver=tgt.HODLRSolver, min_size=128,
                rank=64, seed=42, device=DEV)
    gh.compute(x, yerr)
    assert gh.solver._struct.L == 4
    gb = tgt.GP(chip_smoke.qp_kernel(), solver=tgt.BasicSolver, device=DEV)
    gb.compute(x, yerr)
    gj = JGP(kj, solver=JHODLRSolver, min_size=128, rank=64, seed=42)
    gj.compute(x, yerr)
    ll_h, ll_b, ll_j = (g.log_likelihood(y) for g in (gh, gb, gj))
    assert _rel(ll_h, ll_b) < 1e-6
    assert _rel(ll_h, ll_j) < 1e-6


def test_chunked_assembly_gives_the_unchunked_factors(monkeypatch):
    """A chunk budget of one and a half leaf grams (every leaf a chunk of
    its own, the skeleton table in two): the factors and log-determinant
    are the unchunked ones bit for bit, the compressed matvec agrees to
    rounding, and the leaf grams still reach the Cholesky in one call."""
    rng = np.random.default_rng(3)
    n = 1000
    x = np.sort(rng.uniform(0, 50.0, n))[:, None]
    kt = _smooth_kernels()[1]
    st = TH.build_structure(n, min_size=64, rank=12, seed=42, x_sorted=x)
    xpad = _t(np.concatenate([x, np.repeat(x[-1:], st.n_pad - n, 0)]))
    valid = torch.zeros(st.n_pad, dtype=torch.bool)
    valid[:n] = True
    diag = torch.full((st.n_pad,), 0.09, dtype=torch.float64)
    theta = _t(kt.parameter_vector)
    V = _t(rng.standard_normal((3, st.n_pad)))
    calls = []
    chol = TH._batched_cholesky

    def counted(A):
        calls.append(tuple(A.shape))
        return chol(A)

    monkeypatch.setattr(TH, "_batched_cholesky", counted)

    def run():
        f, ld = TH.hodlr_factor(kt.pair_fn, theta, xpad, valid, diag, st)
        mv = TH._matvec_t(kt.pair_fn, theta, xpad, valid, diag, st, V)
        return f, ld, mv

    f1, ld1, mv1 = run()
    B, m = st.n_pad // st.m, st.m
    monkeypatch.setattr(TH, "_CHUNK_BYTES", 3 * m * m * 8 // 2)
    assert len(TH._chunks(B, m * m * 8)) == B
    assert len(TH._chunks(st.n_pad * st.L, st.rank * 8)) == 2
    f2, ld2, mv2 = run()
    assert calls == [(B, m, m)] * 2
    assert torch.equal(f1["Lleaf"], f2["Lleaf"])
    assert float(ld1) == float(ld2)
    for a, b in zip(f1["levels"], f2["levels"]):
        for u, v in zip(a, b):
            assert torch.equal(u, v)
    torch.testing.assert_close(mv2, mv1, rtol=1e-13, atol=0)


def test_float32_solver_keeps_its_cascade_in_float64():
    """A float32 factorization: leaf factors in float32 (the leaf kernel's
    dtype), the SMW levels and the log-determinant in float64, and the
    public solve and the fused likelihood back in float32; its
    likelihood within 1e-6 of the float64 one on the same pivots."""
    rng = np.random.default_rng(5)
    n = 3000
    x = np.sort(rng.uniform(0, 300.0, n))[:, None]
    y = np.sin(0.1 * x[:, 0]) + 0.3 * rng.standard_normal(n)
    kt = _smooth_kernels()[1]
    gps = {}
    for dt in (torch.float64, torch.float32):
        gps[dt] = tgt.GP(kt, solver=tgt.HODLRSolver, min_size=64, rank=12,
                         device=DEV, dtype=dt)
        gps[dt].compute(x, 0.3 * np.ones(n))
    s = gps[torch.float32].solver
    f = s._factors
    assert f["Lleaf"].dtype == torch.float32
    assert all(t.dtype == torch.float64 for lev in f["levels"] for t in lev)
    r = torch.zeros(s._struct.n_pad, dtype=torch.float32)
    assert TH.hodlr_solve(f, s._struct, r).dtype == torch.float32
    ll = s.loglike_fn()(s._theta, torch.full((n,), 0.09), _t(y, torch.float32))
    assert ll.dtype == torch.float32
    ll64 = gps[torch.float64].log_likelihood(y)
    assert _rel(gps[torch.float32].log_likelihood(y), ll64) < 1e-6
    assert _rel(ll, ll64) < 1e-6
