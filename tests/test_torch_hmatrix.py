# -*- coding: utf-8 -*-
"""The functional core of the port's strong-admissibility H-matrix solver
(``george_tpu_torch/solvers/hmatrix.py``) held against the JAX package's
(``george_tpu/solvers/hmatrix.py``) in float64 on the CPU, on 1-D, 2-D and
3-D data, and against dense oracles.

Tolerances, each beside what it bounds:

* the structure is host numpy with seeded farthest-point pivots: equal,
  element for element;
* the far factors ``(C, Q)`` are compared as the products ``C Q^T`` (the
  factors themselves carry the ridge floor of the interpolation solves,
  see ``tests/test_torch_hodlr.py``): 1e-9 relative, in the Frobenius
  norm of each depth (measured at most 5.3e-10);
* the stored near field (kernel evaluations only): 1e-12;
* the matvec, stored and on the fly, one and several columns: 1e-10
  against the JAX package on the same far factors, 1e-9 on each package's
  own (the factors' bound; measured 3.6e-10 in 1-D), and 1e-6 against the dense ``K``: the JAX
  package's own dense bound on its own data (``tests/test_hmatrix.py``).
  That bound is the compression's, not the port's: with other seeds both
  packages' operators sit up to 2e-6 from ``K`` in 1-D and 2-D, and agree
  with each other to 1e-10 there too;
* PCG: the same iteration count, and the solution to 1e-10.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import george_tpu as jgt
from george_tpu.neighbors import morton_sort_samples as jax_morton
from george_tpu.solvers import hmatrix as JM
import george_tpu_torch as tgt
from george_tpu_torch.convert import kernel_from_reference
from george_tpu_torch.neighbors import morton_sort_samples
from george_tpu_torch.solvers import hmatrix as TM
from george_tpu_torch.solvers import hodlr as TH

torch.set_num_threads(2)

REL_FACTORS = 1e-9
REL_NEAR = 1e-12
REL_REF = 1e-10
REL_DENSE = 1e-6


def _t(a):
    return torch.as_tensor(np.array(a))


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


class Rig(object):
    """One dataset in ``d`` dimensions (n = 1000, padded to 1024 rows of
    32-point leaves), the JAX structure and the port's, and both packages'
    arguments."""

    def __init__(self, d, n=1000, min_size=32, rank=16):
        # the data of the JAX package's dense check (``tests/test_hmatrix.py
        # ::_setup``, seed 0 in every dimension)
        rng = np.random.default_rng(0)
        x = rng.uniform(0, 10, (n, d))
        self.kj = 1.0 * jgt.kernels.ExpSquaredKernel([1.5] * d, ndim=d)
        self.kt = kernel_from_reference(
            1.0 * tgt.kernels.ExpSquaredKernel([1.0] * d, ndim=d),
            self.kj.get_parameter_names(), self.kj.get_parameter_vector())
        self.perm = morton_sort_samples(x)
        self.perm_ref = jax_morton(x)
        xs = x[self.perm]
        self.hj = JM.HMatrixStructure(n, xs, min_size=min_size, rank=rank)
        self.ht = TM.HMatrixStructure(n, xs, min_size=min_size, rank=rank)
        hs = self.hj
        xpad = np.concatenate([xs, np.repeat(xs[-1:], hs.n_pad - n, 0)])
        valid = np.zeros(hs.n_pad, bool)
        valid[:n] = True
        dpad = np.ones(hs.n_pad)
        dpad[:n] = 0.01
        theta = np.asarray(self.kj.parameter_vector)
        self.jargs = tuple(map(jnp.asarray, (theta, xpad, valid, dpad)))
        self.targs = (_t(theta), _t(xpad), _t(valid), _t(dpad))
        pair = self.kj.pair_fn
        # the JAX functions jitted: eager dispatch of their vmaps costs
        # tens of seconds on the CPU
        self.far_j = jax.jit(lambda *a: JM.hmatrix_compress(pair, *a, hs))(
            *self.jargs[:3])
        self.far_t = TM.hmatrix_compress(self.kt.pair_fn, *self.targs[:3],
                                         self.ht)
        self.near_j = jax.jit(
            lambda *a: JM.hmatrix_near_values(pair, *a, hs))(*self.jargs[:3])
        self.matvec_j = jax.jit(
            lambda far, X, near: JM.hmatrix_matvec(pair, *self.jargs, hs,
                                                   far, X, near_vals=near))
        self.near_t = TM.hmatrix_near_values(self.kt.pair_fn,
                                             *self.targs[:3], self.ht)
        self.dense = self.kj.get_value(xs) + 0.01 * np.eye(n)
        self.X = rng.standard_normal((hs.n_pad, 3)) * valid[:, None]
        self.n = n


_RIGS = {}


def _rig(d):
    if d not in _RIGS:
        _RIGS[d] = Rig(d)
    return _RIGS[d]


@pytest.mark.parametrize("d", [1, 2, 3])
def test_port_structure_equals_reference(d):
    """Every field of the partition, including the padded rows' boxes."""
    rig = _rig(d)
    hj, ht = rig.hj, rig.ht
    assert np.array_equal(rig.perm, rig.perm_ref)
    assert ht.n_pad > rig.n                      # the rig needs padding
    for name in ("L", "m", "n_pad", "B", "rank", "rank_growth", "n_near",
                 "n_far"):
        assert getattr(ht, name) == getattr(hj, name), name
    assert np.array_equal(ht.near_nbr, hj.near_nbr)
    assert np.array_equal(ht.near_mask, hj.near_mask)
    # the port's flat near lists hold exactly the ELL lists' entries
    leaf, slot = np.nonzero(hj.near_mask)
    assert sorted(zip(ht.near_rows, ht.near_cols)) == sorted(
        zip(leaf, hj.near_nbr[leaf, slot]))
    assert len(ht.far) == len(hj.far) > 0
    for lt, lj in zip(ht.far, hj.far):
        for key in ("d", "s", "c"):
            assert lt[key] == lj[key]
        for key in ("a", "b", "piv"):
            assert lt[key].dtype == lj[key].dtype
            assert np.array_equal(lt[key], lj[key])
    if d == 2:
        # the boundary law grows the far rank toward the root in 2-D
        cs = [lev["c"] for lev in ht.far]
        assert max(cs) > min(cs)


@pytest.mark.parametrize("d", [1, 2, 3])
def test_port_compress_products_match_reference(d):
    rig = _rig(d)
    assert len(rig.far_t) == len(rig.far_j)
    for (Ct, Qt), (Cj, Qj), lev in zip(rig.far_t, rig.far_j, rig.ht.far):
        P, s, c = len(lev["a"]), lev["s"], lev["c"]
        assert Ct.shape == Qt.shape == (P, s, c)
        got = (Ct @ Qt.mT).numpy()
        ref = np.einsum("psc,ptc->pst", np.asarray(Cj), np.asarray(Qj))
        # in the Frobenius norm over the depth's blocks: the largest
        # single entry of a 1-D coupling can sit where the rank-16 solve
        # is at its ridge floor (1.5e-9 there, Frobenius 2.8e-10)
        assert (np.linalg.norm(got - ref) / np.linalg.norm(ref)
                < REL_FACTORS)


@pytest.mark.parametrize("d", [1, 2, 3])
def test_port_near_values_match_reference(d):
    rig = _rig(d)
    for got, ref in zip(rig.near_t, rig.near_j):
        assert got.shape == ref.shape
        assert _rel(got.numpy(), ref) < REL_NEAR
    # masked-out slots are zero
    Knear = rig.near_t[1].numpy()
    assert not np.any(Knear[~rig.ht.near_mask])


@pytest.mark.parametrize("stored", [True, False], ids=["stored", "on_fly"])
@pytest.mark.parametrize("cols", [0, 3], ids=["vector", "multi"])
@pytest.mark.parametrize("d", [1, 2, 3])
def test_port_matvec_matches_reference_and_dense(d, cols, stored):
    rig = _rig(d)
    X = rig.X[:, 0] if cols == 0 else rig.X
    near_t = rig.near_t if stored else None
    near_j = rig.near_j if stored else None
    ref = np.asarray(rig.matvec_j(rig.far_j, jnp.asarray(X), near_j))
    # the matvec alone: the port's on the JAX package's far factors
    shared = [(_t(C), _t(Q)) for C, Q in rig.far_j]
    got = TM.hmatrix_matvec(rig.kt.pair_fn, *rig.targs, rig.ht, shared,
                            _t(X), near_vals=near_t).numpy()
    assert got.shape == X.shape
    assert _rel(got, ref) < REL_REF
    # end to end, on the port's own factors
    got = TM.hmatrix_matvec(rig.kt.pair_fn, *rig.targs, rig.ht, rig.far_t,
                            _t(X), near_vals=near_t).numpy()
    assert _rel(got, ref) < REL_FACTORS
    n = rig.n
    assert _rel(got[:n], rig.dense @ X[:n]) < REL_DENSE


def test_port_stored_matvec_in_slot_groups(monkeypatch):
    """Many columns make the stored near field's product run over groups of
    slots (here one slot per group): the same result as one group."""
    rig = _rig(2)
    one = TM.hmatrix_matvec(rig.kt.pair_fn, *rig.targs, rig.ht, rig.far_t,
                            _t(rig.X), near_vals=rig.near_t)
    monkeypatch.setattr(TM, "_NEAR_GROUP_BYTES", 1)
    per_slot = TM.hmatrix_matvec(rig.kt.pair_fn, *rig.targs, rig.ht,
                                 rig.far_t, _t(rig.X), near_vals=rig.near_t)
    assert _rel(per_slot.numpy(), one.numpy()) < 1e-13


def test_port_matvec_far_scatter_accumulates_every_pair():
    """A box sits in many far pairs at one depth: the scatter must add
    every pair's contribution (an indexed ``+=`` keeps one per box). The
    far field alone, from a zero diagonal and zero near field, against the
    sum of the explicit ``C Q^T`` blocks."""
    rig = _rig(2)
    ht = rig.ht
    lev, (C, Q) = ht.far[-1], rig.far_t[-1]
    assert len(np.unique(lev["a"])) < len(lev["a"])     # repeated boxes
    X = _t(rig.X)
    theta, xpad, valid, _ = rig.targs
    zero_near = tuple(torch.zeros_like(t) for t in rig.near_t)
    got = TM.hmatrix_matvec(rig.kt.pair_fn, theta, xpad, valid,
                            torch.zeros(ht.n_pad, dtype=X.dtype), ht,
                            rig.far_t, X, include_diag=False,
                            near_vals=zero_near).numpy()
    ref = np.zeros_like(got)
    Xn = rig.X
    for lv, (Cl, Ql) in zip(ht.far, rig.far_t):
        s = lv["s"]
        for p, (a, b) in enumerate(zip(lv["a"], lv["b"])):
            K = (Cl[p] @ Ql[p].mT).numpy()
            ref[a * s:(a + 1) * s] += K @ Xn[b * s:(b + 1) * s]
            ref[b * s:(b + 1) * s] += K.T @ Xn[a * s:(a + 1) * s]
    assert _rel(got, ref) < 1e-12


def _near_plain(rig, theta, X):
    """The near field (leaf diagonal and near pairs) block by block, each
    block an ordinary differentiable torch expression."""
    ht = rig.ht
    B, m = ht.B, ht.m
    _, xpad, valid, _ = rig.targs
    xb, vb = xpad.reshape(B, m, -1), valid.reshape(B, m)
    Xb = X.reshape(B, m, -1)
    blk = lambda i, j: TH._block_matrix(  # noqa: E731
        rig.kt.pair_fn, theta, xb[i], vb[i], xb[j], vb[j])
    rows = [blk(i, i) @ Xb[i] for i in range(B)]
    for i, j in zip(ht.near_rows, ht.near_cols):
        rows[i] = rows[i] + blk(i, j) @ Xb[j]
    return torch.stack(rows).reshape(X.shape)


def _near_on_the_fly(rig, theta, X):
    _, xpad, valid, dpad = rig.targs
    return TM.hmatrix_matvec(rig.kt.pair_fn, theta, xpad, valid, dpad,
                             rig.ht, [], X, include_diag=False)


@pytest.mark.parametrize("mode", ["grad", "vjp", "jvp", "vmap_grad"])
def test_port_on_the_fly_near_field_differentiates(mode):
    """The on-the-fly near field re-evaluates its blocks in its backward and
    forward-mode rules instead of keeping them: every mode against the
    same sum differentiated block by block (1e-12)."""
    rig = _rig(2)
    theta = rig.targs[0]
    X = _t(rig.X)
    W = torch.as_tensor(np.random.default_rng(9).standard_normal(X.shape))

    def loss(f):
        return lambda th, Xv: torch.sum(f(rig, th, Xv) * W)

    if mode == "grad":
        got = torch.func.grad(loss(_near_on_the_fly), argnums=(0, 1))(
            theta, X)
        ref = torch.func.grad(loss(_near_plain), argnums=(0, 1))(theta, X)
    elif mode == "vjp":
        got = torch.func.vjp(lambda th: _near_on_the_fly(rig, th, X),
                             theta)[1](W)
        ref = torch.func.vjp(lambda th: _near_plain(rig, th, X), theta)[1](W)
    elif mode == "jvp":
        tangents = (torch.tensor([0.3, -1.0, 0.5], dtype=X.dtype),
                    torch.ones_like(X))
        got = torch.func.jvp(lambda th, Xv: _near_on_the_fly(rig, th, Xv),
                             (theta, X), tangents)
        ref = torch.func.jvp(lambda th, Xv: _near_plain(rig, th, Xv),
                             (theta, X), tangents)
    else:
        thetas = torch.stack([theta, theta + 0.1])
        got = (torch.func.vmap(torch.func.grad(
            lambda th: loss(_near_on_the_fly)(th, X)))(thetas),)
        ref = (torch.func.vmap(torch.func.grad(
            lambda th: loss(_near_plain)(th, X)))(thetas),)
    for a, b in zip(got, ref):
        assert _rel(a.numpy(), b.numpy()) < 1e-12


def _spd(seed, n=40):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, 2 * n))
    return A @ A.T / (2 * n) + np.eye(n), rng


@pytest.mark.parametrize("precond", ["identity", "spd"])
@pytest.mark.parametrize("cols", [0, 4], ids=["vector", "multi"])
def test_port_pcg_matches_reference(precond, cols):
    A, rng = _spd(5)
    b = rng.standard_normal(40) if cols == 0 else rng.standard_normal(
        (40, cols))
    if precond == "identity":
        Mj, Mt = (lambda r: r), (lambda r: r)
    else:
        # an SPD approximate inverse: the inverse of A perturbed by a
        # random SPD matrix
        E, _ = _spd(6)
        Minv = np.linalg.inv(A + 0.3 * E)
        Mj = lambda r: jnp.asarray(Minv) @ r         # noqa: E731
        Mt = lambda r: _t(Minv) @ r                  # noqa: E731
    xj, itj = JM.pcg_solve(lambda v: jnp.asarray(A) @ v, Mj,
                           jnp.asarray(b), tol=1e-12)
    xt, itt = TM.pcg_solve(lambda v: _t(A) @ v, Mt, _t(b), tol=1e-12)
    assert itt == int(itj)
    assert xt.shape == b.shape
    assert _rel(xt.numpy(), xj) < REL_REF
    assert _rel(xt.numpy(), np.linalg.solve(A, b)) < 1e-9
