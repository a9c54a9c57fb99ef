# -*- coding: utf-8 -*-
"""Strong-admissibility hierarchical solver (H-matrix) for 2-D and 3-D
data: the PyTorch port of ``george_tpu/solvers/hmatrix.py``.

The weak-admissibility HODLR partition (``solvers/hodlr.py``) compresses
every off-diagonal sibling coupling. In d >= 2 adjacent boxes share a
boundary whose interaction rank grows with the boundary, so the skeleton
rank needed for a fixed accuracy grows with n. The strong partition keeps
the interactions of *adjacent* leaf boxes exact and compresses only
*well-separated* box pairs (the dual-tree interaction lists), whose ranks
stay small.

* The dual-tree traversal runs once on the host (numpy) and emits static
  per-depth pair lists; on the device everything is batched gathers and
  matrix products over those lists.
* Far couplings use the weak solver's ridge-CUR skeleton interpolation,
  ``K[a, b] ~= C Q^T`` with ``Q^T = (M^T M + ridge)^{-1} M^T R`` solved
  against the *projected* right-hand side (the design invariant of
  ``hodlr.py``, through the shared :func:`ridge_gram`).
* The exact near field is assembled once per theta and stored when it fits
  ``store_near_budget``; otherwise every matvec evaluates it in batches of
  leaf blocks.
* Solves are preconditioned CG (:func:`pcg_solve`, shared with the sparse
  solver: a Python loop with one host read per iteration). The
  preconditioner, which is also the whitener
  of the log-determinant, is the weak symmetric HODLR factorization ``K_w =
  W W^T`` in float64 on 1-D data (its leaves through the leaf Cholesky
  kernel, ``ops/chol.py``) and a Nystrom whitener from global
  farthest-point pivots otherwise (float32, or any d >= 2).
* ``log det K = log det P + log det(P^{-1/2} K P^{-1/2})``: the first term
  exact from the whitener, the second a stochastic Lanczos quadrature (SLQ)
  of a matrix whose spectrum clusters at 1.
* Gradients: exact quadratic terms and Hutchinson traces, deflated by the
  kernel's dominant subspace with a fitted control variate
  (:meth:`HMatrixSolver.gradient_terms`). The fused likelihood
  (:meth:`HMatrixSolver.loglike_fn`) differentiates its CG solve implicitly
  and its SLQ log-determinant by a Hutchinson adjoint. Its reverse mode
  keeps no pair-function graph: the far factors (:class:`_FarFactors`),
  the stored near field (:class:`_NearValues`) and the on-the-fly one
  (:class:`_NearOnTheFly`) keep only theta and evaluate their blocks
  again, a chunk at a time, in the backward.
"""

import math
import types
import warnings

import numpy as np
import torch

from ..diagnostics import memory_stage, timer
from ..neighbors import morton_sort_samples
from .hodlr import (
    HODLRStructure,
    _block_matrix,
    _cat,
    _chunks,
    _fps_pivots,
    build_structure,
    hodlr_factor_sym,
    hodlr_sqrt_solve,
    ridge_gram,
    select_aca_pivots,
)
from .linalg import _per_member, as_points
from .sparse import lanczos_fn_matvec, pcg_solve, slq_logdet

__all__ = ["HMatrixSolver", "HMatrixStructure", "hmatrix_compress",
           "hmatrix_near_values", "hmatrix_matvec", "pcg_solve"]

_LOG_2PI = math.log(2.0 * math.pi)
# bounds on the temporaries of one group of stored near-field slots and of
# one group of far pairs in hmatrix_matvec
_NEAR_GROUP_BYTES = 1 << 28
_FAR_GROUP_BYTES = 1 << 28


# ---------------------------------------------------------------------------
# Static structure (host-side)
# ---------------------------------------------------------------------------

class HMatrixStructure(object):
    """Static near/far partition of a padded binary box tree.

    Same padding scheme as :class:`HODLRStructure` (``n_pad = m * 2^L``);
    boxes at depth ``d`` are the ``2^d`` contiguous index ranges of size
    ``n_pad >> d``. The dual-tree traversal splits every box pair into

    * ``far[d]``: pairs admissible at depth ``d`` (well-separated:
      ``max(diam_a, diam_b) <= eta * dist(a, b)``), compressed;
    * near leaf pairs: adjacent leaves, kept exact (ELL neighbor lists).

    The traversal and the far pivots register the ``hmatrix.traversal``
    and ``hmatrix.far_pivots`` spans of ``diagnostics``.
    """

    def __init__(self, n, x_sorted, min_size=64, rank=16, eta=1.0,
                 seed=42, rank_growth="auto"):
        self.n = int(n)
        self.eta = float(eta)
        self.seed = int(seed)
        L = 0
        while (self.n + (1 << (L + 1)) - 1) // (1 << (L + 1)) >= min_size:
            L += 1
        self.L = L
        self.m = (self.n + (1 << L) - 1) >> L
        self.n_pad = self.m << L
        self.rank = min(int(rank), self.m)
        B = 1 << L
        self.B = B
        self._device_index = {}
        # Depth-aware interaction rank: a far pair at depth ``d`` couples
        # boxes of side ~ 2^((L-d)/dim) leaf sides, and for smooth kernels
        # the interaction rank scales with the box BOUNDARY measure,
        # ~ side^(dim-1) = 2^((L-d)(dim-1)/dim): constant in 1-D, growing
        # toward the root in d >= 2. ``rank_growth`` is the per-level
        # factor; "auto" applies the boundary law for the data's
        # dimension. The coarse levels hold exponentially fewer pairs, so
        # the extra rank costs little.
        dim = np.asarray(x_sorted).reshape(len(x_sorted), -1).shape[1]
        if rank_growth == "auto":
            rank_growth = 2.0 ** ((dim - 1) / float(max(dim, 1)))
        self.rank_growth = float(rank_growth)

        x = np.asarray(x_sorted, dtype=np.float64)
        if x.ndim == 1:
            x = x[:, None]
        xpad = np.concatenate(
            [x, np.repeat(x[-1:], self.n_pad - self.n, axis=0)], axis=0
        )
        valid = np.zeros(self.n_pad, dtype=bool)
        valid[: self.n] = True

        far = [[] for _ in range(L + 1)]
        near = []
        with timer("hmatrix.traversal"):
            # box bounds per depth from VALID points only (padded rows
            # repeat the last point; a fully padded box is masked)
            self._lo, self._hi, self._nonempty = [], [], []
            for d in range(L + 1):
                s = self.n_pad >> d
                xb = xpad.reshape(1 << d, s, -1)
                vb = valid.reshape(1 << d, s)
                big = np.where(vb[..., None], xb, np.inf)
                small = np.where(vb[..., None], xb, -np.inf)
                self._lo.append(big.min(axis=1))
                self._hi.append(small.max(axis=1))
                self._nonempty.append(vb.any(axis=1))

            def boxdist(d, a, b):
                gap = np.maximum(
                    0.0,
                    np.maximum(
                        self._lo[d][a] - self._hi[d][b],
                        self._lo[d][b] - self._hi[d][a],
                    ),
                )
                return float(np.sqrt((gap ** 2).sum()))

            def diam(d, a):
                e = self._hi[d][a] - self._lo[d][a]
                return float(np.sqrt((e ** 2).sum()))

            def admissible(d, a, b):
                if not (self._nonempty[d][a] and self._nonempty[d][b]):
                    return True  # empty boxes couple nothing
                dist = boxdist(d, a, b)
                return max(diam(d, a), diam(d, b)) <= self.eta * dist

            # host recursion, depth <= L (~20)
            def traverse(d, a, b):
                if a == b:
                    if d < L:
                        traverse(d + 1, 2 * a, 2 * a)
                        traverse(d + 1, 2 * a, 2 * a + 1)
                        traverse(d + 1, 2 * a + 1, 2 * a + 1)
                    return
                if admissible(d, a, b):
                    far[d].append((a, b))
                elif d == L:
                    near.append((a, b))
                else:
                    for ca in (2 * a, 2 * a + 1):
                        for cb in (2 * b, 2 * b + 1):
                            traverse(d + 1, ca, cb)

            traverse(0, 0, 0)

        # FPS skeleton pivots per box per depth (block-local -> absolute)
        rng = np.random.default_rng(seed)
        self.piv = {}
        self.far = []
        with timer("hmatrix.far_pivots"):
            for d in range(L + 1):
                if not far[d]:
                    continue
                s = self.n_pad >> d
                # boundary-law depth-aware rank (see above)
                c = int(round(self.rank * self.rank_growth ** (L - d)))
                c = int(min(max(c, 1), s))
                xb = xpad.reshape(1 << d, s, -1)
                vb = valid.reshape(1 << d, s)
                local = _fps_pivots(xb, vb, c, rng)
                base = (np.arange(1 << d, dtype=np.int64) * s)[:, None]
                self.piv[d] = base + local
                pairs = np.asarray(far[d], dtype=np.int64)
                self.far.append({
                    "d": d, "s": s, "c": c,
                    "a": pairs[:, 0].astype(np.int32),
                    "b": pairs[:, 1].astype(np.int32),
                    "piv": self.piv[d].astype(np.int32),
                })

        # near leaf pairs -> symmetric ELL lists (row i holds every j != i
        # adjacent to i; the leaf diagonal is handled separately)
        lists = [[] for _ in range(B)]
        for (i, j) in near:
            lists[i].append(j)
            lists[j].append(i)
        q_max = max((len(l) for l in lists), default=0)
        q_max = max(q_max, 1)
        nbr = np.zeros((B, q_max), dtype=np.int32)
        nmask = np.zeros((B, q_max), dtype=bool)
        for i, l in enumerate(lists):
            nbr[i, : len(l)] = l
            nmask[i, : len(l)] = True
        self.near_nbr = nbr
        self.near_mask = nmask
        # the same entries as flat (leaf, neighbor) lists in slot order: a
        # Morton range can span the domain, so one leaf may be adjacent to
        # most others and pad every ELL row to that length (2-D, n = 1e5:
        # 1020 slots, 82 used on average); the on-the-fly matvec walks
        # only these
        slot, leaf = np.nonzero(nmask.T)
        self.near_rows = leaf.astype(np.int64)
        self.near_cols = nbr[leaf, slot].astype(np.int64)
        self.n_near = len(near)
        self.n_far = int(sum(len(f) for f in far))

    def index(self, name, device, level=None):
        """``far[level][name]`` (or the attribute ``name`` when ``level``
        is None) as a tensor on ``device`` (indices as ``long``), copied
        there once per structure and device."""
        key = (name, level, str(device))
        t = self._device_index.get(key)
        if t is None:
            a = getattr(self, name) if level is None else self.far[level][name]
            if a.dtype != bool:
                a = a.astype(np.int64)
            t = torch.as_tensor(a, device=device)
            self._device_index[key] = t
        return t


# ---------------------------------------------------------------------------
# Functional core (pure tensors, differentiable)
# ---------------------------------------------------------------------------

def hmatrix_compress(pair_fn, theta, xpad, valid, hs, ridge_floor=None):
    """Ridge-CUR factors ``K[a, b] ~= C @ Q^T`` for every far pair.

    The weak solver's interpolation and design invariant, through the
    shared :func:`ridge_gram`: ``Q^T = G^{-1} (M^T R)`` with the ridge
    pseudo-inverse solved against the PROJECTED right-hand side.
    ``ridge_floor`` carries the ``tol_abs`` semantics. Returns a list (one
    entry per populated depth) of ``(C, Q)``, each ``(P, s, c)``.
    """
    return _FarBlocks(pair_fn, xpad, valid, hs, ridge_floor).factors(theta)


class _FarBlocks(object):
    """The far factors of :func:`hmatrix_compress` in chunks of pairs:
    ``chunks`` lists ``(depth index, slice of its pairs)``, each chunk's
    kernel entries (``M``, ``C`` and ``R``) under ``hodlr._CHUNK_BYTES``,
    and ``pairs(theta, li, sl)`` compresses one chunk. The pairs are
    independent, so a chunk is the same arithmetic as its rows of the
    whole depth."""

    def __init__(self, pair_fn, xpad, valid, hs, ridge_floor=None):
        dev = xpad.device
        self.pair_fn, self.xpad, self.valid = pair_fn, xpad, valid
        self.hs, self.ridge_floor = hs, ridge_floor
        self.idx = [(hs.index("a", dev, li), hs.index("b", dev, li),
                     hs.index("piv", dev, li)) for li in range(len(hs.far))]
        itemsize = xpad.element_size()
        self.chunks = [
            (li, sl) for li, lev in enumerate(hs.far)
            for sl in _chunks(len(lev["a"]),
                              (2 * lev["s"] + lev["c"]) * lev["c"] * itemsize)]

    def pairs(self, theta, li, sl):
        """``(C, Q)`` of the pairs ``sl`` of depth ``li``."""
        s = self.hs.far[li]["s"]
        a, b, piv = self.idx[li]
        a, b = a[sl], b[sl]
        xpad, valid, pair = self.xpad, self.valid, self.pair_fn
        xd = xpad.reshape(self.hs.n_pad // s, s, -1)
        vd = valid.reshape(self.hs.n_pad // s, s)
        I_a, J_b = piv[a], piv[b]                      # (P, c) absolute
        xI, vI = xpad[I_a], valid[I_a]
        xJ, vJ = xpad[J_b], valid[J_b]
        M = _block_matrix(pair, theta, xI, vI, xJ, vJ)        # (P, c, c)
        C = _block_matrix(pair, theta, xd[a], vd[a], xJ, vJ)  # (P, s, c)
        R = _block_matrix(pair, theta, xI, vI, xd[b], vd[b])  # (P, c, s)
        G = ridge_gram(M, self.ridge_floor)
        rhs = torch.einsum("pkc,pks->pcs", M, R)       # projected M^T R
        Qt = torch.linalg.solve(G, rhs)                # (P, c, s)
        return C, Qt.mT

    def per_depth(self, fn):
        """``fn(li, sl)``, a ``(C, Q)``-shaped pair of one chunk, over
        every chunk, concatenated per depth."""
        out = [([], []) for _ in self.hs.far]
        for li, sl in self.chunks:
            for acc, t in zip(out[li], fn(li, sl)):
                acc.append(t)
        return [(_cat(Cs), _cat(Qs)) for Cs, Qs in out]

    def factors(self, theta):
        """Every depth's ``(C, Q)``."""
        return self.per_depth(lambda li, sl: self.pairs(theta, li, sl))


class _FarFactors(torch.autograd.Function):
    """The far factors of :class:`_FarBlocks` at ``theta``, with only
    ``theta`` kept for the derivatives: the backward and the forward-mode
    rule compress each chunk of pairs again under ``torch.func.vjp`` /
    ``jvp``, so reverse mode holds one chunk's graph at a time where plain
    autograd through :func:`hmatrix_compress` keeps every intermediate of
    the pair function for every far pair (about 3e8 skeleton entries at
    n = 1e5 in 2-D) until the end of the backward pass. The same
    rematerialization as :class:`_NearOnTheFly`.

    Arguments: ``(far, theta)``; returns the flat tuple ``(C_0, Q_0, C_1,
    Q_1, ...)``. Under ``torch.func.vmap`` the batch members run one after
    another."""

    @staticmethod
    def forward(far, theta):
        return tuple(t for cq in far.factors(theta) for t in cq)

    @staticmethod
    def setup_context(ctx, inputs, output):
        far, theta = inputs
        ctx.far = far
        ctx.save_for_backward(theta)
        ctx.save_for_forward(theta)

    @staticmethod
    def vmap(info, in_dims, *args):
        return _per_member(_FarFactors.apply, info, in_dims, args)

    @staticmethod
    def backward(ctx, *grads):
        (theta,) = ctx.saved_tensors
        far = ctx.far
        g_theta = torch.zeros_like(theta)
        with memory_stage("hmatrix.compress.backward"), torch.no_grad():
            for li, sl in far.chunks:
                _, vjp_fn = torch.func.vjp(
                    lambda th: far.pairs(th, li, sl), theta)
                g_theta = g_theta + vjp_fn(
                    (grads[2 * li][sl], grads[2 * li + 1][sl]))[0]
        return None, g_theta

    @staticmethod
    def jvp(ctx, _, theta_t):
        (theta,) = ctx.saved_tensors
        far = ctx.far
        tangents = far.per_depth(lambda li, sl: torch.func.jvp(
            lambda th: far.pairs(th, li, sl), (theta,), (theta_t,))[1])
        return tuple(t for cq in tangents for t in cq)


def hmatrix_near_values(pair_fn, theta, xpad, valid, hs):
    """The exact near field ``(Kbb (B, m, m), Knear (B, q, m, m))``, with
    masked-out slots zeroed.

    Iterative loops (CG, Lanczos) at a fixed theta assemble this once and
    pass it to :func:`hmatrix_matvec` as ``near_vals``: the near-field
    kernel evaluations otherwise repeat every iteration and dominate the
    matvec. It holds ``B (q + 1) m^2`` entries; the solver gates it on a
    memory budget (``store_near``).
    """
    return _NearSlots(pair_fn, xpad, valid, hs).values(theta)


class _NearSlots(object):
    """The stored near field of :func:`hmatrix_near_values` by ELL slot:
    ``diag(theta)`` is the leaf diagonal ``(B, m, m)``, ``slot(theta, q)``
    the ``q``-th neighbour block of every leaf, zero where the slot is
    padding."""

    def __init__(self, pair_fn, xpad, valid, hs):
        B, m, dev = hs.B, hs.m, xpad.device
        self.pair_fn = pair_fn
        self.xb, self.vb = xpad.reshape(B, m, -1), valid.reshape(B, m)
        self.nbr = hs.index("near_nbr", dev)
        self.nmask = hs.index("near_mask", dev)
        self.q = self.nbr.shape[1]

    def diag(self, theta):
        return _block_matrix(self.pair_fn, theta, self.xb, self.vb, self.xb,
                             self.vb)

    def slot(self, theta, q):
        j = self.nbr[:, q]
        Kij = _block_matrix(self.pair_fn, theta, self.xb, self.vb,
                            self.xb[j], self.vb[j])        # (B, m, m)
        return torch.where(self.nmask[:, q, None, None], Kij, 0.0)

    def values(self, theta):
        """``(Kbb, Knear)``."""
        return self.diag(theta), torch.stack(
            [self.slot(theta, q) for q in range(self.q)], dim=1)


class _NearValues(torch.autograd.Function):
    """The stored near field at ``theta`` with only ``theta`` kept for the
    backward, which evaluates each slot again, as :class:`_FarFactors`
    does for the far factors: reverse mode holds one slot's pair-function
    graph at a time where plain autograd through
    :func:`hmatrix_near_values` keeps every slot's.

    Arguments: ``(near, theta)`` with ``near`` a :class:`_NearSlots`;
    returns ``(Kbb, Knear)``. Under ``torch.func.vmap`` the batch members
    run one after another."""

    @staticmethod
    def forward(near, theta):
        return near.values(theta)

    @staticmethod
    def setup_context(ctx, inputs, output):
        near, theta = inputs
        ctx.near = near
        ctx.save_for_backward(theta)

    @staticmethod
    def vmap(info, in_dims, *args):
        return _per_member(_NearValues.apply, info, in_dims, args)

    @staticmethod
    def backward(ctx, g_bb, g_near):
        (theta,) = ctx.saved_tensors
        near = ctx.near
        with memory_stage("hmatrix.near.backward"), torch.no_grad():
            _, vjp_fn = torch.func.vjp(near.diag, theta)
            g_theta = vjp_fn(g_bb)[0]
            for q in range(near.q):
                _, vjp_fn = torch.func.vjp(lambda th: near.slot(th, q),
                                           theta)
                g_theta = g_theta + vjp_fn(g_near[:, q])[0]
        return None, g_theta


def hmatrix_matvec(pair_fn, theta, xpad, valid, diag_pad, hs, far_factors,
                   X, include_diag=True, near_vals=None):
    """``(K_strong + diag) X``: the exact near field (from ``near_vals``
    when stored, else assembled in batches of ``B`` leaf blocks) and the
    compressed far field from ``far_factors``. ``X``: ``(n_pad,)`` or
    ``(n_pad, k)``."""
    squeeze = X.ndim == 1
    if squeeze:
        X = X[:, None]
    k = X.shape[1]
    B, m = hs.B, hs.m
    dev = X.device
    Xb = X.reshape(B, m, k)

    if near_vals is not None:
        Kbb, Knear = near_vals
        nbr = hs.index("near_nbr", dev)
        Y = Kbb @ Xb
        if include_diag:
            Y = Y + diag_pad.reshape(B, m, 1) * Xb
        # the stored neighbor slots as batched products over groups of
        # slots, each group's (B, g, m, k) product held under
        # _NEAR_GROUP_BYTES (one group for a few columns; a contraction
        # over (q, j) at once would copy the table into a (B, m, q m)
        # layout on every call)
        q = nbr.shape[1]
        g = max(1, _NEAR_GROUP_BYTES // (X.numel() * X.element_size()))
        for q0 in range(0, q, g):
            sl = slice(q0, q0 + g)
            Y = Y + (Knear[:, sl] @ Xb[nbr[:, sl]]).sum(dim=1)
    else:
        Y = _NearOnTheFly.apply(_NearBlocks(pair_fn, xpad, valid, hs),
                                theta, Xb)
        if include_diag:
            Y = Y + diag_pad.reshape(B, m, 1) * Xb
    Y = Y.reshape(hs.n_pad, k)

    # compressed far field: y_a += C (Q^T x_b), y_b += Q (C^T x_a)
    # [K_ba = K_ab^T]. A box appears in many pairs, so the scatter is an
    # index_add (an indexed += would keep one contribution per box). The
    # pairs go in groups whose gathered (g, s, k) blocks stay under
    # _FAR_GROUP_BYTES: one group for a few columns, while a wide block (the
    # gradient's [alpha, deflation basis, probes], ~700 columns at
    # n = 1e5) would otherwise gather tens of GB per depth
    for li, (lev, (C, Q)) in enumerate(zip(hs.far, far_factors)):
        s = lev["s"]
        a, b = hs.index("a", dev, li), hs.index("b", dev, li)
        Xd = X.reshape(hs.n_pad // s, s, k)
        Yd = torch.zeros_like(Xd)
        g = max(1, _FAR_GROUP_BYTES // (s * k * X.element_size()))
        for p0 in range(0, a.shape[0], g):
            sl = slice(p0, p0 + g)
            Cg, Qg, ag, bg = C[sl], Q[sl], a[sl], b[sl]
            ya = Cg @ (Qg.mT @ Xd[bg])                 # (g, s, k)
            yb = Qg @ (Cg.mT @ Xd[ag])
            Yd = Yd.index_add(0, ag, ya).index_add(0, bg, yb)
        Y = Y + Yd.reshape(hs.n_pad, k)

    return Y[:, 0] if squeeze else Y


# _BACKWARD_NO_GRAD: the backward rules below run under torch.no_grad().
# torch.func.grad (and so grad_and_value, as minimize and the samplers
# call it) runs every backward with create_graph=True; a rule that
# accumulates per-chunk vjps in grad mode then records each chunk's graph
# into its result and keeps all of them alive until the whole backward
# ends: the near field's block intermediates at every chunk, and the
# log-determinant adjoint's recompression. The vjps inside still work
# (a function transform ignores an outer no_grad); the rules are not
# differentiable again, as PCG's host-read stopping test never was.


class _NearBlocks(object):
    """The exact near field's blocks in batches of at most ``B``: the leaf
    diagonal, then the near leaf pairs (the ELL lists' padding slots
    skipped). ``block(theta, i, j)`` evaluates one batch ``(b, m, m)``."""

    def __init__(self, pair_fn, xpad, valid, hs):
        B, m, dev = hs.B, hs.m, xpad.device
        self.pair_fn = pair_fn
        self.xb, self.vb = xpad.reshape(B, m, -1), valid.reshape(B, m)
        leaves = torch.arange(B, device=dev)
        rows = hs.index("near_rows", dev)
        cols = hs.index("near_cols", dev)
        self.chunks = [(leaves, leaves)] + [
            (rows[c0:c0 + B], cols[c0:c0 + B])
            for c0 in range(0, rows.shape[0], B)]

    def block(self, theta, i, j):
        return _block_matrix(self.pair_fn, theta, self.xb[i], self.vb[i],
                             self.xb[j], self.vb[j])


class _NearOnTheFly(torch.autograd.Function):
    """The near field evaluated on the fly, ``Y[i] = sum_j K(theta)[i, j]
    X[j]`` over :class:`_NearBlocks`' batches, with no batch's blocks kept
    past its product in any mode: the backward and the forward-mode rule
    evaluate each batch again (the JAX package runs this assembly under
    ``jax.checkpoint``; ``torch.utils.checkpoint`` does not compose with
    ``torch.func``). Plain reverse mode would keep every block of the near
    field alive with its intermediates: 83,596 blocks of 98 x 98 and
    several times their size at n = 1e5 in 2-D.

    Arguments: ``(near, theta, Xb)``, ``Xb`` ``(B, m, k)``. Under
    ``torch.func.vmap`` the batch members run one after another."""

    @staticmethod
    def forward(near, theta, Xb):
        Y = torch.zeros_like(Xb)
        for i, j in near.chunks:
            Y = Y.index_add(0, i, near.block(theta, i, j) @ Xb[j])
        return Y

    @staticmethod
    def setup_context(ctx, inputs, output):
        near, theta, Xb = inputs
        ctx.near = near
        ctx.save_for_backward(theta, Xb)
        ctx.save_for_forward(theta, Xb)

    @staticmethod
    def vmap(info, in_dims, *args):
        return _per_member(_NearOnTheFly.apply, info, in_dims, args)

    @staticmethod
    def backward(ctx, G):
        theta, Xb = ctx.saved_tensors
        near = ctx.near
        g_theta, g_X = torch.zeros_like(theta), torch.zeros_like(Xb)
        with torch.no_grad():       # see _BACKWARD_NO_GRAD
            for i, j in near.chunks:
                K, vjp_fn = torch.func.vjp(lambda th: near.block(th, i, j),
                                           theta)
                Gi = G[i]
                g_X = g_X.index_add(0, j, K.mT @ Gi)
                g_theta = g_theta + vjp_fn(Gi @ Xb[j].mT)[0]
        return None, g_theta, g_X

    @staticmethod
    def jvp(ctx, _, theta_t, Xb_t):
        theta, Xb = ctx.saved_tensors
        near = ctx.near
        Y_t = torch.zeros_like(Xb)
        for i, j in near.chunks:
            if theta_t is None:
                K, c = near.block(theta, i, j), 0.0
            else:
                K, dK = torch.func.jvp(lambda th: near.block(th, i, j),
                                       (theta,), (theta_t,))
                c = dK @ Xb[j]
            if Xb_t is not None:
                c = c + K @ Xb_t[j]
            Y_t = Y_t.index_add(0, i, c)
        return Y_t


def _split_parts(hs, parts):
    """``(far_factors, near_vals)`` from the flat tuple ``(C_0, Q_0, C_1,
    Q_1, ..., [Kbb, Knear])`` that the fused likelihood's Functions carry
    as tensor arguments."""
    nf = 2 * len(hs.far)
    far = list(zip(parts[0:nf:2], parts[1:nf:2]))
    near = tuple(parts[nf:]) or None
    return far, near


def _op_solve(op, theta, diag, parts, B):
    """``(K + diag)^{-1} B`` by PCG through ``op.mv`` with ``op``'s frozen
    preconditioner and CG controls."""
    return pcg_solve(lambda Y: op.mv(theta, diag, parts, Y), op.precond, B,
                     tol=op.tol, maxiter=op.maxiter)[0]


class _Solve(torch.autograd.Function):
    """:func:`_op_solve` for the backward rules, which run batched under the
    samplers' ``vmap``: its ``vmap`` rule runs the batch members one after
    another (PCG's stopping test reads the host). Arguments: ``(op, theta,
    diag, B, *parts)``. Used under ``no_grad``, never differentiated."""

    @staticmethod
    def forward(op, theta, diag, B, *parts):
        return _op_solve(op, theta, diag, parts, B)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, *args):
        return _per_member(_Solve.apply, info, in_dims, args)


class _QuadForm(torch.autograd.Function):
    """``(q, z)``: ``z = (K + diag)^{-1} r`` by PCG through ``op.mv(theta,
    diag, parts, Y)`` and the quadratic form ``q = r^T z``, differentiable
    in ``q`` by implicit differentiation with no second solve: ``dq = 2
    z^T dr - z^T dK z``, so the backward is ``r_bar = 2 g z`` and the
    vector-Jacobian product of ``K(theta, diag, parts) z`` at fixed ``z``
    with cotangent ``-g z``. The JAX package differentiates the same solve
    with ``custom_linear_solve``, whose transpose solves again for ``K^{-1}
    (g r)``, which is ``g z``. ``z`` is returned for reading and is not
    differentiable.

    Arguments: ``(op, theta, diag, r, *parts)``; ``op`` carries the
    matvec, the frozen preconditioner and the CG controls. Under
    ``torch.func.vmap`` the batch members run one after another: PCG's
    stopping test reads the host."""

    @staticmethod
    def forward(op, theta, diag, r, *parts):
        z = _op_solve(op, theta, diag, parts, r)
        return torch.dot(r, z), z

    @staticmethod
    def setup_context(ctx, inputs, output):
        op, theta, diag, _, *parts = inputs
        ctx.op = op
        ctx.mark_non_differentiable(output[1])
        ctx.save_for_backward(theta, diag, output[1], *parts)

    @staticmethod
    def vmap(info, in_dims, *args):
        return _per_member(_QuadForm.apply, info, in_dims, args)

    @staticmethod
    def backward(ctx, g, _):
        theta, diag, z, *parts = ctx.saved_tensors
        op = ctx.op
        with memory_stage("hmatrix.quad.backward"), torch.no_grad():
            _, vjp_fn = torch.func.vjp(
                lambda th, dg, *pa: op.mv(th, dg, pa, z), theta, diag,
                *parts)
            g_theta, g_diag, *g_parts = vjp_fn(-g * z)
        return (None, g_theta, g_diag, 2.0 * g * z) + tuple(g_parts)


class _SandwichLogdet(torch.autograd.Function):
    """``log det(K + diag) = base + SLQ(log det(P^{-1/2} (K + diag)
    P^{-1/2}))`` with the whitener ``P`` frozen at compute-theta (exact for
    any fixed SPD ``P``), and the Hutchinson adjoint of the JAX package's
    ``ld_total``: PCG on the adjoint probe block ``V``, then the gradient
    in ``theta`` and ``diag`` of ``h(th, dg) = mean_k (K^{-1} V)_k^T K(th,
    dg) V_k`` (the Hutchinson estimate of ``tr(K^{-1} dK)``), with the far
    factors and near field recompressed inside ``h``. The cotangent for
    ``parts`` is zero: the backward re-derives the whole theta dependence,
    so a nonzero one would count the gradient twice.

    Arguments: ``(op, theta, diag, *parts)``. Under ``torch.func.vmap``
    the batch members run one after another."""

    @staticmethod
    def forward(op, theta, diag, *parts):
        def sandwich(v):
            return op.whiten(op.mv(theta, diag, parts, op.whitenT(v)))

        return op.base + slq_logdet(sandwich, op.probes,
                                    num_steps=op.num_steps)

    @staticmethod
    def setup_context(ctx, inputs, output):
        op, theta, diag, *parts = inputs
        ctx.op = op
        ctx.save_for_backward(theta, diag, *parts)

    @staticmethod
    def vmap(info, in_dims, *args):
        return _per_member(_SandwichLogdet.apply, info, in_dims, args)

    @staticmethod
    def backward(ctx, g):
        theta, diag, *parts = ctx.saved_tensors
        op = ctx.op
        V = op.adjoint_probes
        with memory_stage("hmatrix.logdet.backward"), torch.no_grad():
            KinvV = _Solve.apply(op, theta, diag, V, *parts)

            def h(th, dg):
                KV = op.mv(th, dg, op.parts_of(th), V)
                return torch.mean(torch.sum(KinvV * KV, dim=0))

            g_theta, g_diag = torch.func.grad(h, argnums=(0, 1))(theta,
                                                                 diag)
        return (None, g * g_theta, g * g_diag) + (None,) * len(parts)


# ---------------------------------------------------------------------------
# Solver (george protocol)
# ---------------------------------------------------------------------------

class HMatrixSolver(object):
    """Strong-admissibility hierarchical solver with the george solver
    protocol: the high-accuracy option for 2-D and 3-D inputs, where the
    weak (HODLR) partition needs impractically large ranks.

    :param kernel: covariance kernel.
    :param min_size: leaf box size floor (as ``HODLRSolver``).
    :param rank: skeleton rank of the *far* couplings at the finest depth
        (grown toward the root by ``rank_growth``).
    :param eta: admissibility parameter; a pair is far iff ``max(diam) <=
        eta * dist``. Smaller: more exact near pairs, more accurate and
        more expensive.
    :param precond_rank: skeleton rank of the weak symmetric HODLR
        whitener on the float64 1-D path (default ``4 * rank``; it caps at
        the leaf size).
    :param nystrom_rank: rank of the Nystrom whitener (float32, or d >= 2).
        ``"auto"`` is ``min(n_pad, 4096, max(256, n_pad // 8))``: in d >= 2
        the kernel's effective rank grows with n, and the SLQ bias follows
        what the whitener misses.
    :param cg_tol: relative PCG tolerance (floored at ``30 eps`` of the
        working dtype); ``maxiter``: the PCG iteration cap.
    :param num_probes / num_steps: SLQ controls for the log-determinant
        correction, and the probe count of the gradient.
    :param seed: seeds the far and Nystrom pivots (numpy) and the probes:
        the SLQ probes come from a ``torch.Generator`` seeded with ``seed``,
        the gradient probes with ``seed + 1``.
    :param probes: explicit SLQ probe matrix ``(num_probes, n_pad)``
        (numpy), e.g. to share probes with another implementation; the
        fused likelihood's adjoint block is the same buffer read as
        ``(n_pad, num_probes)``, as the JAX package draws it.
    :param grad_probes: explicit gradient probe matrix ``(num_probes, n)``
        in the original point order.
    :param pivots: the weak whitener's skeleton pivots on the float64 1-D
        path: ``None`` for the ACA walk, or one ``(row_piv, col_piv)`` pair
        of absolute padded-row arrays per level.
    :param store_near / store_near_budget: store the near field (``"auto"``:
        when its bytes fit the budget, 2 GiB by default).
    :param tol_abs: absolute floor of the skeleton interpolation ridge.
    :param grad_deflation_rank: rank of the Hutch++-style deflation basis of
        the gradient's trace terms. ``"auto"`` keeps every Nystrom direction
        whose whitened eigenvalue exceeds ``_DEFLATION_S2_FLOOR``, capped by
        the basis size and ``_DEFLATION_BUDGET_BYTES`` (64 FPS kernel
        columns on the float64 1-D path), and warns when that leaves the
        deflation rank-starved; an int forces a rank; 0 disables it.
    :param rank_growth: per-level far-rank growth toward the root;
        ``"auto"`` is the boundary law ``2^((dim-1)/dim)``.
    :param verbose: print the ``hmatrix.*`` spans (registered in
        ``diagnostics`` either way).
    :param device: torch device (default ``"cuda"``; pass ``"cpu"``
        explicitly on a host without a card).
    :param dtype: working dtype (default ``torch.float64``).
    """

    # "auto" deflation keeps every Nystrom eigendirection whose whitened
    # eigenvalue (the kernel-to-noise ratio in that direction) exceeds this
    # floor: the Hutchinson variance of tr(K^{-1} dK) goes like sum
    # (s2/(1+s2))^2 over undeflated directions, so the long 2-D tail of
    # O(1)..O(0.01) eigenvalues carries the noise while holding almost no
    # trace energy
    _DEFLATION_S2_FLOOR = 0.01
    # ... capped so the extra K^{-1} basis columns stay under this budget
    _DEFLATION_BUDGET_BYTES = 256 * 1024 * 1024

    matrix_free = True

    def __init__(self, kernel, min_size=64, rank=16, eta=1.0,
                 precond_rank=None, nystrom_rank="auto", cg_tol=1e-10,
                 maxiter=200, num_probes=16, num_steps=12, seed=42,
                 sort=True, verbose=False, store_near="auto",
                 store_near_budget=2 << 30, tol_abs=None,
                 grad_deflation_rank="auto", rank_growth="auto",
                 probes=None, grad_probes=None, pivots=None,
                 device="cuda", dtype=torch.float64, **kwargs):
        self.kernel = kernel
        self.min_size = int(min_size)
        self.rank = int(rank)
        self.rank_growth = rank_growth
        self.precond_rank = (
            4 * self.rank if precond_rank is None else int(precond_rank)
        )
        self.nystrom_rank = (
            nystrom_rank if nystrom_rank == "auto" else int(nystrom_rank)
        )
        self.eta = float(eta)
        self.cg_tol = float(cg_tol)
        self.maxiter = int(maxiter)
        self.num_probes = int(num_probes)
        self.num_steps = int(num_steps)
        self.seed = int(seed)
        self.sort = bool(sort)
        self.verbose = bool(verbose)
        self.store_near = store_near
        self.store_near_budget = int(store_near_budget)
        self.tol_abs = None if tol_abs is None else float(tol_abs)
        if grad_deflation_rank != "auto":
            grad_deflation_rank = int(grad_deflation_rank)
        self.grad_deflation_rank = grad_deflation_rank
        self.probes = probes
        self.grad_probes = grad_probes
        self.pivots = pivots
        self.device = torch.device(device)
        self.dtype = dtype
        self.computed = False
        self.log_determinant = None
        self.last_cg_iters = None

    def _tensor(self, a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64)).to(
            device=self.device, dtype=self.dtype)

    def _probe_matrix(self, given, shape, seed):
        """Rademacher probes of ``shape``: ``given`` (numpy) or drawn from
        a generator seeded with ``seed``."""
        if given is not None:
            given = np.asarray(given, dtype=np.float64)
            if given.shape != shape:
                raise ValueError("probes must have shape %s, got %s"
                                 % (shape, given.shape))
            return self._tensor(given)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        bits = torch.randint(0, 2, shape, generator=gen, device=self.device)
        return (2 * bits - 1).to(self.dtype)

    # -- setup -------------------------------------------------------------

    def compute(self, x, yerr=0.0, nns=None, **kwargs):
        with timer("hmatrix.compute", verbose=self.verbose) as tm:
            tm.sync(self._compute(x, yerr))
        if not np.isfinite(self.log_determinant):
            raise np.linalg.LinAlgError("H-matrix log-determinant diverged")
        self.computed = True

    def _compute(self, x, yerr):
        x = as_points(x)
        n = len(x)
        verbose = self.verbose
        yerr2 = np.atleast_1d(np.asarray(yerr, dtype=np.float64)) ** 2
        if yerr2.size == 1:
            yerr2 = yerr2 * np.ones(n)

        # geometry coordinates exclude any label column (the LCM task id):
        # see ``LCMKernel.sort_axes`` and the same logic in HODLRSolver
        sa = getattr(self.kernel, "sort_axes", None)
        x_geom = x if sa is None else x[:, list(sa)]
        self._perm = (
            morton_sort_samples(x_geom) if self.sort
            else np.arange(n, dtype=np.int64)
        )
        self._perm_t = torch.as_tensor(self._perm, device=self.device)
        xs = x[self._perm]
        hs = HMatrixStructure(
            n, x_geom[self._perm], min_size=self.min_size, rank=self.rank,
            eta=self.eta, seed=self.seed, rank_growth=self.rank_growth,
        )
        self._hs = hs
        xpad = np.concatenate(
            [xs, np.repeat(xs[-1:], hs.n_pad - n, axis=0)], axis=0
        )
        valid = np.zeros(hs.n_pad, dtype=bool)
        valid[:n] = True
        diag_pad = np.ones(hs.n_pad)
        diag_pad[:n] = yerr2[self._perm]

        self._x = x
        self._xpad_np, self._valid_np = xpad, valid
        self._xpad = self._tensor(xpad)
        self._valid = torch.as_tensor(valid, device=self.device)
        self._far_blocks = _FarBlocks(self.kernel.pair_fn, self._xpad,
                                      self._valid, hs, self.tol_abs)
        self._near_slots = _NearSlots(self.kernel.pair_fn, self._xpad,
                                      self._valid, hs)
        self._diag_pad = self._tensor(diag_pad)
        self._theta = self._tensor(self.kernel.parameter_vector)
        pair, theta = self.kernel.pair_fn, self._theta
        self._slq_probes = self._probe_matrix(
            self.probes, (self.num_probes, hs.n_pad), self.seed)

        with torch.no_grad():
            # the strong operator at the compute-time theta
            with timer("hmatrix.compress", verbose) as tm:
                self._far = tm.sync(self._far_blocks.factors(theta))
            # store the near field when it fits the budget: CG and Lanczos
            # then pay one gather and contraction per iteration instead of
            # evaluating every near block again
            itemsize = torch.finfo(self.dtype).bits // 8
            self.near_bytes = (hs.B * (hs.near_nbr.shape[1] + 1) * hs.m
                               * hs.m * itemsize)
            do_store = (
                bool(self.store_near) if self.store_near != "auto"
                else self.near_bytes <= self.store_near_budget
            )
            self._near = None
            if do_store:
                with timer("hmatrix.near", verbose) as tm:
                    self._near = tm.sync(self._near_slots.values(theta))

            # float32 cannot reach 1e-10 residuals: floor the tolerance at
            # the dtype's achievable accuracy
            self._eff_tol = max(
                self.cg_tol, 30.0 * float(torch.finfo(self.dtype).eps))
            # The symmetric weak-HODLR whitener is a 1-D float64 tool: in
            # d >= 2 the weak off-diagonal remainder makes the square-root
            # cascade ill-conditioned even in float64, and in float32 it
            # amplifies rounding. The Nystrom whitener is stable in any
            # dimension.
            self._st = None
            self._sym = None
            self._nystrom = None
            with timer("hmatrix.whitener", verbose) as tm:
                if self.dtype == torch.float64 and x.shape[1] == 1:
                    ld_base = tm.sync(self._build_sym_whitener(n, xs))
                else:
                    ld_base = tm.sync(self._build_nystrom())
            self._ld_base = float(ld_base)

            with timer("hmatrix.slq", verbose) as tm:
                ld_corr = tm.sync(slq_logdet(
                    lambda v: self._whiten(self._mv(self._whitenT(v))),
                    self._slq_probes, num_steps=self.num_steps))
        self.log_determinant = self._ld_base + float(ld_corr)
        return ld_corr

    def _build_sym_whitener(self, n, xs):
        """Float64 1-D: the weak symmetric HODLR cascade ``K_w = W W^T`` at
        ``precond_rank``, its leaves through the leaf Cholesky kernel.
        Returns ``log det K_w``."""
        if self.pivots is not None:
            st = HODLRStructure(n, min_size=self.min_size,
                                rank=self.precond_rank, seed=self.seed,
                                pivots=self.pivots)
        else:
            st = build_structure(n, min_size=self.min_size,
                                 rank=self.precond_rank, seed=self.seed,
                                 x_sorted=xs)
            if st.L > 0:
                select_aca_pivots(self.kernel.pair_fn,
                                  self.kernel.parameter_vector,
                                  self._xpad_np, self._valid_np, st)
        self._st = st
        self._sym, ld_weak = hodlr_factor_sym(
            self.kernel.pair_fn, self._theta, self._xpad, self._valid,
            self._diag_pad, st)
        return ld_weak

    def _build_nystrom(self):
        """Float32 or d >= 2: a Nystrom whitener from ``R`` global
        farthest-point pivots. After noise whitening, ``M = I + B B^T`` with
        ``B = D^{-1/2} C L_W^{-T}`` has an exact SPD inverse and square root
        through one thin orthonormalization and a small ``eigh``, so CG
        converges in a few iterations and ``log det K = log det D + log det
        M`` (exact) + SLQ of the whitened sandwich. Returns ``log det D +
        log det M``."""
        hs, pair, theta = self._hs, self.kernel.pair_fn, self._theta
        dtype = self.dtype
        R = (
            min(hs.n_pad, 4096, max(256, hs.n_pad // 8))
            if self.nystrom_rank == "auto"
            else min(self.nystrom_rank, hs.n_pad)
        )
        self.nystrom_rank_effective = R
        with timer("hmatrix.nystrom_fps", self.verbose):
            piv = _fps_pivots(self._xpad_np[None], self._valid_np[None], R,
                              np.random.default_rng(self.seed))[0]
        piv = torch.as_tensor(piv, device=self.device)
        xpiv, vpiv = self._xpad[piv], self._valid[piv]
        eps = torch.finfo(dtype).eps
        eye = torch.eye(R, dtype=dtype, device=self.device)

        def cholqr(Bq):
            # tall-skinny orthonormalization by CholQR (gram, Cholesky,
            # right-side triangular solve)
            G = Bq.mT @ Bq
            Lg = torch.linalg.cholesky(
                G + (100.0 * eps * torch.trace(G) / R) * eye)
            return torch.linalg.solve_triangular(Lg.mT, Bq, upper=True,
                                                 left=False), Lg

        with timer("hmatrix.nystrom_columns", self.verbose) as tm:
            C = _block_matrix(pair, theta, self._xpad, self._valid, xpiv,
                              vpiv)                            # (n_pad, R)
            W = _block_matrix(pair, theta, xpiv, vpiv, xpiv, vpiv)
            LW = torch.linalg.cholesky(
                W + (100.0 * eps * torch.trace(W) / R) * eye)
            C /= torch.sqrt(self._diag_pad)[:, None]
            Bm = tm.sync(torch.linalg.solve_triangular(LW.mT, C, upper=True,
                                                       left=False))
            del C, W, LW
        with timer("hmatrix.nystrom_cholqr", self.verbose) as tm:
            # CholQR2: one reorthogonalization pass makes the basis
            # orthonormal to working precision; Bm = Q (L2^T L1^T)
            Q1, L1 = cholqr(Bm)
            del Bm
            Q, L2 = cholqr(Q1)
            del Q1
            Rq = tm.sync(L2.mT @ L1.mT)
        with timer("hmatrix.nystrom_eigh", self.verbose) as tm:
            lam, U = torch.linalg.eigh(Rq @ Rq.mT)
            Q2 = tm.sync(Q @ U)
        s2 = torch.clamp_min(lam, 0.0)
        self._nystrom = (Q2, s2)
        return torch.sum(torch.log1p(s2)) + torch.sum(
            torch.log(self._diag_pad))

    # -- operators at the compute-time state --------------------------------

    def _parts(self, theta):
        """The strong operator's flat parts at ``theta``: the far factors
        (compressed again in the derivatives, :class:`_FarFactors`) and,
        when the solver stores it, the near field."""
        parts = list(_FarFactors.apply(self._far_blocks, theta))
        if self._near is not None:
            parts.extend(_NearValues.apply(self._near_slots, theta))
        return tuple(parts)

    def _mv_of(self, theta, diag, parts, Y):
        far, near = _split_parts(self._hs, parts)
        return hmatrix_matvec(self.kernel.pair_fn, theta, self._xpad,
                              self._valid, diag, self._hs, far, Y,
                              near_vals=near)

    def _mv(self, Y):
        """``(K + diag) Y`` at the compute-time theta, from the stored far
        factors and near field."""
        return hmatrix_matvec(self.kernel.pair_fn, self._theta, self._xpad,
                              self._valid, self._diag_pad, self._hs,
                              self._far, Y, near_vals=self._near)

    def _mv_theta(self, theta, Y):
        """``(K(theta) + diag) Y`` recompressed at ``theta`` with the near
        field on the fly: the form to differentiate in ``theta``."""
        far, _ = _split_parts(self._hs,
                              _FarFactors.apply(self._far_blocks, theta))
        return hmatrix_matvec(self.kernel.pair_fn, theta, self._xpad,
                              self._valid, self._diag_pad, self._hs, far, Y)

    def _precond(self, R):
        if self._nystrom is None:
            return hodlr_sqrt_solve(
                self._sym, self._st,
                hodlr_sqrt_solve(self._sym, self._st, R), transpose=True)
        Q2, s2 = self._nystrom
        dis = 1.0 / torch.sqrt(self._diag_pad)
        Yd = dis[:, None] * (R if R.ndim == 2 else R[:, None])
        Yd = Yd - Q2 @ ((s2 / (1.0 + s2))[:, None] * (Q2.mT @ Yd))
        out = dis[:, None] * Yd
        return out if R.ndim == 2 else out[:, 0]

    def _msqrt_inv(self, v):
        """``M^{-1/2} v`` of the Nystrom whitener."""
        Q2, s2 = self._nystrom
        squeeze = v.ndim == 1
        V = v[:, None] if squeeze else v
        out = V + Q2 @ ((((1.0 + s2) ** -0.5) - 1.0)[:, None] * (Q2.mT @ V))
        return out[:, 0] if squeeze else out

    def _dis(self, v):
        d = torch.sqrt(self._diag_pad)
        return v / (d if v.ndim == 1 else d[:, None])

    def _whiten(self, v):
        """``P^{-1/2} v``: ``W^{-1} v``, or ``M^{-1/2} D^{-1/2} v``."""
        if self._nystrom is None:
            return hodlr_sqrt_solve(self._sym, self._st, v)
        return self._msqrt_inv(self._dis(v))

    def _whitenT(self, v):
        """``P^{-T/2} v``: ``W^{-T} v``, or ``D^{-1/2} M^{-1/2} v``."""
        if self._nystrom is None:
            return hodlr_sqrt_solve(self._sym, self._st, v, transpose=True)
        return self._dis(self._msqrt_inv(v))

    def _solve(self, B):
        """``(K + diag)^{-1} B`` by PCG at the compute-time state; returns
        ``(X, iterations)``."""
        with torch.no_grad():
            return pcg_solve(self._mv, self._precond, B, tol=self._eff_tol,
                             maxiter=self.maxiter)

    # -- fused likelihood ----------------------------------------------------

    def loglike_fn(self):
        """Pure ``f(theta_kernel, diag, r) -> log-likelihood`` through the
        strong-admissibility machinery (the fused contract ``GP.log_prob_fn``
        consumes): far recompression and near assembly per theta, the
        quadratic term by PCG with an implicit adjoint (:class:`_QuadForm`),
        and the frozen-whitener SLQ log-determinant with a Hutchinson
        adjoint (:class:`_SandwichLogdet`). The whitener and the sandwich
        base stay at compute-theta: the identity ``log det(K(th) + D) = log
        det P + log det(P^{-1/2} (K(th) + D) P^{-1/2})`` is exact for any
        fixed SPD ``P``; only the SLQ variance grows as theta leaves
        compute-theta (recompute to re-center). ``diag`` and ``r`` are in
        the original point order."""
        hs = self._hs
        n, pad = hs.n, hs.n_pad - hs.n
        perm = self._perm_t
        op = types.SimpleNamespace(
            mv=self._mv_of, parts_of=self._parts, precond=self._precond,
            whiten=self._whiten, whitenT=self._whitenT,
            base=self._ld_base, probes=self._slq_probes,
            # the adjoint's probe block is the SLQ probes' buffer read as
            # (n_pad, num_probes): the JAX package's draw of that shape
            # from the same key
            adjoint_probes=self._slq_probes.reshape(hs.n_pad,
                                                    self.num_probes),
            tol=self._eff_tol, maxiter=self.maxiter,
            num_steps=self.num_steps)

        def loglike(theta_k, diag, r):
            diag_pad = torch.cat([diag[perm], diag.new_ones(pad)])
            r_pad = torch.cat([r[perm], r.new_zeros(pad)])
            # one far compression and near assembly per evaluation, shared
            # by the quadratic term and the log-determinant
            with memory_stage("hmatrix.ll.parts"):
                parts = self._parts(theta_k)
            with memory_stage("hmatrix.ll.pcg"):
                quad, _ = _QuadForm.apply(op, theta_k, diag_pad, r_pad,
                                          *parts)
            with memory_stage("hmatrix.ll.slq"):
                ld = _SandwichLogdet.apply(op, theta_k, diag_pad, *parts)
            return -0.5 * (quad + ld + n * _LOG_2PI)

        return loglike

    # -- protocol ----------------------------------------------------------

    def _pad(self, y):
        """``y`` (numpy or a tensor, ``(n,)`` or ``(n, k)``) in the sorted
        order with zero padding rows, on the solver's device."""
        Y = y if isinstance(y, torch.Tensor) else self._tensor(y)
        Y = Y[self._perm_t]
        pad = Y.new_zeros((self._hs.n_pad - Y.shape[0],) + Y.shape[1:])
        return torch.cat([Y, pad])

    def _unpad(self, z):
        z = z[: len(self._perm)].detach().cpu().numpy().astype(np.float64)
        out = np.empty_like(z)
        out[self._perm] = z
        return out

    def apply_inverse(self, y, in_place=False):
        z, self.last_cg_iters = self._solve(self._pad(y))
        return self._unpad(z)

    def solve_columns(self, R):
        """``(K + diag)^{-1} R`` for columns ``R (n, k)`` in the original
        point order by PCG (:meth:`_solve`), on the solver's device in its
        dtype, staying there."""
        n = len(self._perm)
        Z, self.last_cg_iters = self._solve(self._pad(R))
        out = torch.empty_like(R)
        out[self._perm_t] = Z[:n]
        return out

    def dot_solve(self, y):
        yp = self._pad(y)
        z, self.last_cg_iters = self._solve(yp)
        return float(torch.dot(yp, z))

    def apply_forward(self, y, i=0):
        """``(K + diag) y`` (``i == 0``, the stored operator) or ``dK/d
        theta_{i-1} y`` (``torch.func.jvp`` of the recompressing matvec)."""
        yp = self._pad(y)
        if i == 0:
            with torch.no_grad():
                return self._unpad(self._mv(yp))
        tangent = torch.zeros_like(self._theta)
        tangent[i - 1] = 1.0
        _, Z = torch.func.jvp(lambda th: self._mv_theta(th, yp),
                              (self._theta,), (tangent,))
        return self._unpad(Z)

    def get_inverse(self):
        return self.apply_inverse(np.eye(len(self._perm)))

    def apply_sqrt(self, r, num_steps=None):
        """Rows of ``r`` transported by the symmetric square root ``(K +
        diag)^{1/2}``: Lanczos ``f(A) b`` over the compressed matvec, all
        rows as one block, ``num_steps`` steps (default: ``num_steps``
        floored at 30)."""
        m = int(num_steps) if num_steps is not None else max(
            self.num_steps, 30)
        r = np.asarray(r, dtype=np.float64)
        squeeze = r.ndim == 1
        R = r[None, :] if squeeze else r                     # (size, n)
        with torch.no_grad():
            cols = lanczos_fn_matvec(self._mv, self._pad(R.T), torch.sqrt,
                                     num_steps=m)           # (n_pad, size)
        out = self._unpad(cols).T
        return out[0] if squeeze else out

    # -- matrix-free gradient -------------------------------------------------

    def _grad_deflation_basis(self):
        """Orthonormal ``(n_pad, r)`` basis for Hutch++-style trace
        deflation, reused across every ``dK/dtheta_k``: the top eigenvectors
        of the Nystrom whitener, or on the float64 1-D path a thin QR of
        kernel columns at global FPS pivots.

        ``"auto"`` resolves the rank against the Nystrom spectrum (every
        direction with ``s2`` above ``_DEFLATION_S2_FLOOR``, capped by the
        basis size and the memory budget) and warns when the cut leaves
        directions above the floor: the deflation is then rank-starved and
        ``nystrom_rank`` is the knob to raise."""
        spec = self.grad_deflation_rank
        nys = self._nystrom
        if spec == "auto":
            if nys is None:
                # float64 1-D: the smooth subspace is small
                r = 64
            else:
                s2d = np.sort(nys[1].cpu().numpy().astype(np.float64))[::-1]
                floor = self._DEFLATION_S2_FLOOR
                want = int(np.sum(s2d > floor))
                itemsize = torch.finfo(self.dtype).bits // 8
                cap = max(16, self._DEFLATION_BUDGET_BYTES
                          // (self._hs.n_pad * itemsize))
                r = max(16, min(want, int(cap), len(s2d)))
                if want > r or (want == len(s2d) and s2d[-1] > floor):
                    warnings.warn(
                        "HMatrixSolver gradient deflation is rank-starved: "
                        "the retained basis (rank %d of %d) leaves whitened "
                        "directions above the variance floor %.0e "
                        "undeflated (smallest retained eigenvalue %.2e). The "
                        "trace-term noise reduction will be partial; raise "
                        "nystrom_rank toward the kernel's effective rank."
                        % (r, len(s2d), floor, s2d[r - 1]),
                        RuntimeWarning,
                    )
        else:
            r = int(spec)
        r = min(r, self._hs.n_pad - 1)
        if r <= 0:
            return None
        if nys is not None:
            Q2, s2 = nys
            if r >= Q2.shape[1]:
                return Q2
            top = torch.argsort(s2, stable=True)[-r:]    # eigh: ascending
            return Q2[:, top]
        piv = _fps_pivots(self._xpad_np[None], self._valid_np[None], r,
                          np.random.default_rng(self.seed + 3))[0]
        piv = torch.as_tensor(piv, device=self.device)
        with torch.no_grad():
            C = _block_matrix(self.kernel.pair_fn, self._theta, self._xpad,
                              self._valid, self._xpad[piv], self._valid[piv])
            Q, _ = torch.linalg.qr(C * self._valid[:, None])
        return Q

    def gradient_terms(self, alpha):
        """The gradient terms for ``a = alpha``: the kernel block over the
        kernel's full parameter vector, exact ``1/2 a^T dK_k a`` and
        ``tr(K^{-1} dK_k)`` by Hutchinson with a deflation basis ``Q`` as a
        fitted control variate, and ``diag(a a^T - K^{-1})`` with
        ``diag(K^{-1})`` from the plain probes.

        With ``P = I - Q Q^T`` and ``Y = K^{-1} Q`` (one multi-RHS PCG batch
        ``[Q, probes]``), ``tr(Q^T K^{-1} dK Q) + E_u[(P u)^T K^{-1} dK (P
        u)]`` is unbiased, and ``K^{-1} P u = K^{-1} u - Y Q^T u`` comes from
        the same batch. In d >= 2 the projector can smear the diagonal-
        dominant near field into off-diagonals, so per parameter the plain
        and deflated estimators combine as ``plain - beta (plain -
        deflated)`` with ``beta`` in [0, 1] fitted from the same probes
        (an O(1/num_probes) bias traded for variance). Every sample comes
        from one ``torch.func.jvp`` of the recompressing matvec over ``[a,
        Q, P u]`` per parameter."""
        alpha = np.asarray(alpha, dtype=np.float64)
        theta = self._theta
        nparam = int(theta.shape[0])
        probes = self._pad(self._probe_matrix(
            self.grad_probes, (self.num_probes, len(alpha)),
            self.seed + 1).mT)                             # (n_pad, P)
        alpha_p = self._pad(alpha)

        Q = self._grad_deflation_basis()
        if Q is not None:
            r = Q.shape[1]
            sols, self.last_cg_iters = self._solve(
                torch.cat([Q, probes], dim=1))
            Y, Kinv_u = sols[:, :r], sols[:, r:]
            QtU = Q.mT @ probes
            probes_d = probes - Q @ QtU                  # deflated P u
            Kinv_ud = Kinv_u - Y @ QtU                   # K^{-1} P u
            av = torch.cat([alpha_p[:, None], Q, probes_d], dim=1)
            del sols
        else:
            Kinv_u, self.last_cg_iters = self._solve(probes)
            av = torch.cat([alpha_p[:, None], probes], dim=1)

        grads = np.zeros(nparam)
        for k in range(nparam):
            tangent = torch.zeros_like(theta)
            tangent[k] = 1.0
            _, dK_av = torch.func.jvp(lambda th: self._mv_theta(th, av),
                                      (theta,), (tangent,))
            with torch.no_grad():
                alpha_term = 0.5 * float(torch.dot(alpha_p, dK_av[:, 0]))
                if Q is not None:
                    dKQ, dKud = dK_av[:, 1:1 + r], dK_av[:, 1 + r:]
                    exact = torch.sum(Y * dKQ)
                    defl_p = torch.sum(Kinv_ud * dKud, dim=0) + exact
                    plain_p = torch.sum(Kinv_u * (dKud + dKQ @ QtU), dim=0)
                    D = plain_p - defl_p                 # zero-mean
                    Dc = D - torch.mean(D)
                    pc = plain_p - torch.mean(plain_p)
                    beta = torch.clamp(
                        torch.dot(pc, Dc)
                        / torch.clamp_min(torch.dot(Dc, Dc), 1e-30),
                        0.0, 1.0)
                    trace_est = float(torch.mean(plain_p)
                                      - beta * torch.mean(D))
                else:
                    trace_est = float(torch.mean(
                        torch.sum(Kinv_u * dK_av[:, 1:], dim=0)))
            grads[k] = alpha_term - 0.5 * trace_est
            del dK_av

        with torch.no_grad():
            diag_Kinv = self._unpad(torch.mean(probes * Kinv_u, dim=1))
        return grads, alpha ** 2 - diag_Kinv

    # pickling drops the device state; a restored solver needs a compute
    def __getstate__(self):
        state = self.__dict__.copy()
        for k in ("_hs", "_st", "_sym", "_nystrom", "_far", "_far_blocks",
                  "_near", "_near_slots", "_xpad", "_valid", "_diag_pad",
                  "_theta", "_slq_probes", "_xpad_np", "_valid_np",
                  "_perm_t"):
            state.pop(k, None)
        state["computed"] = False
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
