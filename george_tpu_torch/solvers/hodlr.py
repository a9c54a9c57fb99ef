# -*- coding: utf-8 -*-
"""Hierarchical (HODLR-class) solver — PyTorch port of
``george_tpu/solvers/hodlr.py`` in its transposed cascade layout.

The factorization is the level-by-level SMW cascade

    K = D · F_L · F_{L-1} ... F_1,

where ``D`` is the block-diagonal of leaf boxes (batched Cholesky: the
hand-written CUDA kernel on a CUDA tensor, ``ops/chol.py``) and
``F_l = I + W_l Z_l^T`` is block-diagonal over the ``2^(l-1)`` sibling
pairs of level ``l``, with ``Z_l`` the raw skeleton (CUR) factors and
``W_l`` the same factors with all finer factors' inverses applied. Each
pair's ``2c x 2c`` core ``I + Z^T W`` is inverted batched; the log
determinant accumulates the leaf Cholesky diagonals and the cores'
``slogdet``.

Layout: every level factor is stored TRANSPOSED, ``(c, n_pad)``, and every
multi-RHS batch as ``(k, n_pad)`` — the one layout the port carries. The
JAX package's row layout, width-bounded ancestor-update groups and
mesh-sharding pins were workarounds for the TPU's memory and lane tiling
and are not ported. Its chunked leaf sweeps are, in another form: the leaf
grams and the skeleton entry table are evaluated in chunks of at most
``_CHUNK_BYTES`` of entries, because eager torch materializes each
temporary of the pair function (and under ``jvp`` its tangents) that XLA
would fuse.

Precision: the working dtype (``dtype=``) holds the bulk of the work —
the kernel entries, the leaf grams, the leaf Cholesky kernel and its
triangular solves, the gradient's forward-mode pass — while the SMW
cascade above the leaves, every level of a solve and the skeleton
interpolants' ridge systems run in float64 (``_CASCADE``), where a float32
run on the TPU kept them in float32.

Gradients: the whole factorization is differentiable torch code, so
autograd through :meth:`HODLRSolver.loglike_fn` gives the exact gradient
of the compressed likelihood; :func:`hodlr_loglike_and_grad_hutchinson`
is the forward-mode, matrix-free alternative (exact quadratic terms,
Hutchinson traces) from ``torch.func.jvp`` of the compressed matvec.

The symmetric variant :func:`hodlr_factor_sym` factors the same
compressed operator as ``K = W W^T`` (the same leaf Cholesky, then one
orthonormalized symmetric node per sibling pair and level), for prior
draws (``apply_sqrt``), ``sym=True`` solves and the symmetric Hutchinson
estimator.

Under ``mesh=`` both factorizations split the padded rows over the ranks
of a ``torch.distributed`` group (``HODLRStructure.set_shard``): each rank
factors its own leaves and the levels whose sibling pairs it holds whole;
the per-pair sums of a coarser level are reduced over the ranks, and the
symmetric node of such a level is built on every rank from the gathered
level factor.

Points are pre-sorted host-side (``neighbors.morton_sort_samples``, on the
kernel's ``sort_axes`` where it declares them) so off-diagonal blocks are
numerically low-rank; the skeleton pivots are static indices chosen once
per ``compute`` on the host: by the ACA walk, or from a kNN matrix
(neighbor-guided farthest points). Every first compute of a configuration
checks its factorization against the compressed operator
(:meth:`HODLRSolver._factorization_self_check`).
"""

import contextlib
import math
import warnings

import numpy as np
import torch

from ..diagnostics import annotate, backward_mark, count_host_read, timer
from ..neighbors import knn_indices, morton_sort_samples
from ..ops import chol as _chol
from ..ops.chol import cholesky as _batched_cholesky
from ..parallel.collectives import broadcast, replicated, row_shard
from .linalg import as_points

__all__ = ["HODLRSolver", "HODLRStructure", "build_structure",
           "select_aca_pivots", "hodlr_factor", "hodlr_solve",
           "hodlr_matvec", "hodlr_matvec_factors", "hodlr_solve_refined",
           "hodlr_loglike_and_grad_hutchinson", "ridge_gram",
           "hodlr_factor_sym", "hodlr_sqrt_matvec", "hodlr_sqrt_solve"]

_LOG_2PI = math.log(2.0 * math.pi)


# ---------------------------------------------------------------------------
# Static structure (host-side)
# ---------------------------------------------------------------------------

class HODLRStructure(object):
    """Static shape/index data for a padded binary HODLR partition.

    ``n`` real points are padded to ``n_pad = m * 2^L`` (leaf size ``m``,
    ``L`` levels). Level ``l`` (1-based, 1 = root split) has ``2^(l-1)``
    sibling pairs of block size ``s_l = n_pad / 2^l``; each pair carries
    ``c_l = min(rank, s_l)`` skeleton pivots per side.

    ``nns``: optional rectangular neighbor matrix ``(n, k)`` in the sorted
    order (``-1`` = missing): each level's farthest-point pivots are
    reordered so that points with neighbors in the sibling block come
    first (:func:`_nn_guided_pivots`).

    ``pivots``: optional per-level ``(row_piv, col_piv)`` arrays of
    absolute padded-row indices, shape ``(p_l, c_l)`` each, to adopt
    instead of drawing farthest-point pivots (how
    ``convert.structure_from_arrays`` carries another structure's
    skeletons over).
    """

    def __init__(self, n, min_size=64, rank=32, seed=42, x_sorted=None,
                 nns=None, ridge_floor=None, pivots=None):
        self.n = int(n)
        self.shard = None
        self.seed = int(seed)
        # absolute floor for the interpolation ridge (the ``tol_abs``
        # accuracy knob); None keeps the pure machine-eps floor
        self.ridge_floor = None if ridge_floor is None else float(ridge_floor)
        L = 0
        while (self.n + (1 << (L + 1)) - 1) // (1 << (L + 1)) >= min_size:
            L += 1
        self.L = L
        self.m = (self.n + (1 << L) - 1) >> L
        self.n_pad = self.m << L
        # a uniform skeleton rank across levels lets the entry assembly
        # and interpolation solves batch over ALL levels at once
        self.rank = min(int(rank), self.m)
        self.levels = []
        if pivots is not None:
            if len(pivots) != L:
                raise ValueError(
                    "expected pivots for %d levels, got %d" % (L, len(pivots))
                )
            for lev, (row_piv, col_piv) in enumerate(pivots, start=1):
                s = self.n_pad >> lev
                p = 1 << (lev - 1)
                c = min(self.rank, s)
                row_piv = np.asarray(row_piv, dtype=np.int64)
                col_piv = np.asarray(col_piv, dtype=np.int64)
                if row_piv.shape != (p, c) or col_piv.shape != (p, c):
                    raise ValueError(
                        "level %d pivots must have shape %s" % (lev, (p, c))
                    )
                self.levels.append({"s": s, "p": p, "c": c,
                                    "row_piv": row_piv, "col_piv": col_piv})
            self._build_flat()
            return
        rng = np.random.default_rng(seed)
        if x_sorted is not None:
            xpad = np.concatenate(
                [
                    x_sorted,
                    np.repeat(x_sorted[-1:], self.n_pad - self.n, axis=0),
                ],
                axis=0,
            )
        else:
            xpad = np.arange(self.n_pad, dtype=np.float64)[:, None]
        vpad = np.zeros(self.n_pad, dtype=bool)
        vpad[: self.n] = True
        if nns is not None:
            nns = np.asarray(nns, dtype=np.int64)
            nns = np.concatenate(
                [nns, -np.ones((self.n_pad - len(nns), nns.shape[1]),
                               dtype=np.int64)], axis=0)
        for lev in range(1, L + 1):
            s = self.n_pad >> lev
            p = 1 << (lev - 1)
            c = min(self.rank, s)
            blocks = xpad.reshape(p, 2, s, -1)
            vmask = vpad.reshape(p, 2, s)
            row_piv = _fps_pivots(blocks[:, 0], vmask[:, 0], c, rng)
            col_piv = _fps_pivots(blocks[:, 1], vmask[:, 1], c, rng)
            if nns is not None:
                # neighbor-guided skeletons: for a decaying kernel the
                # coupling energy of a sibling pair sits on the points that
                # have neighbors across the interface, so those rank first
                nb = np.where(nns >= 0, nns // s, -1)
                own = np.arange(self.n_pad, dtype=np.int64) // s
                sib = np.where(own % 2 == 0, own + 1, own - 1)
                counts = (nb == sib[:, None]).sum(axis=1).reshape(p, 2, s)
                row_piv = _nn_guided_pivots(row_piv, counts[:, 0],
                                            vmask[:, 0], c)
                col_piv = _nn_guided_pivots(col_piv, counts[:, 1],
                                            vmask[:, 1], c)
            # convert block-local positions to absolute padded-row indices
            base = (np.arange(p, dtype=np.int64) * 2 * s)[:, None]
            self.levels.append(
                {"s": s, "p": p, "c": c,
                 "row_piv": base + row_piv,
                 "col_piv": base + s + col_piv}
            )
        self._build_flat()

    def _build_flat(self):
        """Cross-level flattened index arrays so kernel-entry assembly and
        the interpolation solves run as ONE batched op over all levels."""
        self._device_index = {}
        L = self.L
        if L == 0:
            self.flat = None
            self._build_local()
            return
        c = self.rank
        rp_all = np.concatenate([lv["row_piv"] for lv in self.levels])
        cp_all = np.concatenate([lv["col_piv"] for lv in self.levels])
        pair_offset = np.cumsum([0] + [lv["p"] for lv in self.levels])
        self.flat = {
            "c": c,
            "rp_all": rp_all,                        # (P, c)
            "cp_all": cp_all,
            "pair_offset": [int(v) for v in pair_offset],
            # the pivots each row's skeleton entries are taken at, per
            # pair: its J (right block) for a left row, its I for a right
            # row
            "piv_tab": np.stack([cp_all, rp_all], axis=1).reshape(-1, c),
        }
        self._build_local()

    def set_shard(self, shard):
        """Split the padded rows over the ranks of ``shard`` (a
        ``parallel.collectives.RowShard``; ``None``: one process holds
        them all). Each rank holds a contiguous block of whole leaves, so
        the leaf work and every level whose sibling pairs tile the ranks
        are local; a coarser level's pair spans ranks, and its per-pair
        sums are reduced over them (:func:`_half_dots`)."""
        if shard is not None and (self.n_pad // self.m) % shard.world:
            raise ValueError(
                "%d leaves do not split evenly over %d ranks"
                % (self.n_pad // self.m, shard.world))
        self.shard = shard
        self._build_local()

    def _build_local(self):
        """This rank's rows (``row0``, ``nloc``) and, per level, the view
        of them as ``(np, nh, sl)`` blocks: ``np`` sibling pairs from pair
        ``p0``, ``nh`` halves from half ``h0`` (0 = left), ``sl`` rows
        per half. ``whole`` levels hold both halves of their pairs; the
        others hold part of one half of one pair."""
        world = 1 if self.shard is None else self.shard.world
        r = 0 if self.shard is None else self.shard.rank
        self.nloc = self.n_pad // world
        self.row0 = r * self.nloc
        self.views = []
        pids = []
        for li, lev in enumerate(self.levels):
            s, p = lev["s"], lev["p"]
            if p % world == 0:
                v = {"p0": r * (p // world), "np": p // world, "h0": 0,
                     "nh": 2, "sl": s, "whole": True}
            else:
                v = {"p0": self.row0 // (2 * s), "np": 1,
                     "h0": (self.row0 // s) % 2, "nh": 1, "sl": self.nloc,
                     "whole": False}
            self.views.append(v)
            if self.flat is not None:
                pair = self.flat["pair_offset"][li] + v["p0"] + np.arange(
                    v["np"], dtype=np.int64)
                half = v["h0"] + np.arange(v["nh"], dtype=np.int64)
                pid = 2 * pair[:, None] + half[None, :]
                pids.append(np.repeat(pid.ravel(), v["sl"]))
        if self.flat is not None:
            self.flat["pid_loc"] = np.concatenate(pids)
            self.flat["rows_loc"] = np.tile(
                np.arange(self.row0, self.row0 + self.nloc, dtype=np.int64),
                self.L)
        self._device_index = {}

    def index(self, name, device):
        """``flat[name]`` as a long tensor on ``device``, copied there once
        per structure and device."""
        key = (name, str(device))
        idx = self._device_index.get(key)
        if idx is None:
            idx = torch.as_tensor(self.flat[name], dtype=torch.long,
                                  device=device)
            self._device_index[key] = idx
        return idx


def _fps_pivots(xb, vmask, c, rng):
    """Seeded farthest-point-sampling pivots, batched over all blocks of a
    level. ``xb``: ``(p, s, d)`` block coordinates; returns block-local
    indices ``(p, c)``."""
    p, s, _ = xb.shape
    valid = np.where(vmask, 0.0, -np.inf)              # (p, s)
    nvalid = vmask.sum(axis=1)
    start = (rng.uniform(size=p) * np.maximum(nvalid, 1)).astype(np.int64)
    start = np.minimum(start, np.maximum(nvalid - 1, 0))
    piv = np.empty((p, c), dtype=np.int64)
    piv[:, 0] = start
    last = xb[np.arange(p), start]                     # (p, d)
    d2 = ((xb - last[:, None, :]) ** 2).sum(-1) + valid
    for t in range(1, c):
        nxt = d2.argmax(axis=1)
        piv[:, t] = nxt
        last = xb[np.arange(p), nxt]
        d2 = np.minimum(d2, ((xb - last[:, None, :]) ** 2).sum(-1) + valid)
    return piv


def _nn_guided_pivots(fps_piv, counts, vmask, c):
    """Merge FPS pivots with cross-block neighbor counts: points with
    cross-neighbors rank first (by count, FPS order breaking ties), the
    remaining slots fill in FPS order. ``fps_piv``: ``(p, c)`` block-local
    picks in FPS order; ``counts``/``vmask``: ``(p, s)``."""
    p, s = counts.shape
    score = np.where(vmask, counts.astype(np.float64) * (c + 1), -np.inf)
    fscore = np.zeros((p, s))
    fscore[np.repeat(np.arange(p), c), fps_piv.ravel()] = np.tile(
        np.arange(c, 0, -1, dtype=np.float64), p)
    order = np.argsort(-(score + fscore), axis=1, kind="stable")
    return order[:, :c].astype(np.int64)


def build_structure(n, min_size=64, rank=32, seed=42, x_sorted=None,
                    nns=None, ridge_floor=None):
    return HODLRStructure(
        n, min_size=min_size, rank=rank, seed=seed, x_sorted=x_sorted,
        nns=nns, ridge_floor=ridge_floor,
    )


def _host_f64(a):
    if isinstance(a, torch.Tensor):
        return a.detach().to("cpu", torch.float64)
    return torch.as_tensor(np.asarray(a, dtype=np.float64))


def _aca_level_pivots(pair_fn, theta, xl, vl, xr, vr, c):
    """Kernel-adaptive skeleton pivots by batched partial-pivot ACA, one
    step per rank slot, batched over all sibling pairs of a level.

    Each step evaluates one residual row and column of every pair's
    coupling block and pivots on the largest remaining entry, so the
    skeleton follows the actual kernel (geometry-only pivots miss
    oscillatory structure). ``xl``/``xr``: ``(p, s, d)`` left/right block
    coordinates; ``vl``/``vr``: validity masks. Returns block-local
    ``(p, c)`` row and column pivots."""
    p, s, _ = xl.shape
    ar = torch.arange(p)
    U = torch.zeros((p, s, c), dtype=xl.dtype)
    Vt = torch.zeros((p, c, s), dtype=xl.dtype)
    used_r = ~vl
    used_c = ~vr
    # start from the last valid row — for sorted 1-D data this is the
    # sibling interface, elsewhere a harmless seed
    i = torch.argmax(torch.where(vl, torch.arange(s), -1), dim=1)
    Ipiv = torch.zeros((p, c), dtype=torch.long)
    Jpiv = torch.zeros((p, c), dtype=torch.long)
    neg = -math.inf
    for k in range(c):
        xi = xl[ar, i]                                           # (p, d)
        row = torch.where(vr, pair_fn(theta, xi[:, None, :], xr), 0.0)
        row = row - torch.bmm(U[ar, i][:, None, :], Vt)[:, 0]
        j = torch.argmax(torch.where(used_c, neg, row.abs()), dim=1)
        pv = row[ar, j]
        xj = xr[ar, j]
        col = torch.where(vl, pair_fn(theta, xl, xj[:, None, :]), 0.0)
        col = col - torch.bmm(U, Vt[ar, :, j][:, :, None])[:, :, 0]
        denom = torch.where(pv.abs() > 1e-300, pv, 1.0)
        U[:, :, k] = col / denom[:, None]
        Vt[:, k, :] = row
        Ipiv[:, k] = i
        Jpiv[:, k] = j
        used_r[ar, i] = True
        used_c[ar, j] = True
        i = torch.argmax(torch.where(used_r, neg, col.abs()), dim=1)
    return Ipiv, Jpiv


def select_aca_pivots(pair_fn, theta, xpad, valid, struct):
    """Re-pivot every level of ``struct`` with kernel-adaptive ACA
    skeletons (in place), then rebuild the flattened index arrays.

    This walk runs on the host CPU in float64 whatever device and dtype
    the factorization uses — by design, not as a fallback. The pivots are
    setup-time indices, so where they are chosen is free; the walk's
    residual downdates cancel heavily and its argmax choices flip under
    lower-precision arithmetic, and pivots chosen in accelerator float32
    measurably degraded the factorization (the JAX package moved the same
    walk to host float64 for that reason). Host float64 also makes the
    pivots independent of the device the solver runs on.
    """
    x = _host_f64(xpad)
    v = torch.as_tensor(np.asarray(valid, dtype=bool))
    th = _host_f64(theta)
    with torch.no_grad():
        for lev in struct.levels:
            s, p, c = lev["s"], lev["p"], lev["c"]
            xb = x.reshape(p, 2, s, -1)
            vb = v.reshape(p, 2, s)
            Ipiv, Jpiv = _aca_level_pivots(
                pair_fn, th, xb[:, 0], vb[:, 0], xb[:, 1], vb[:, 1], c
            )
            base = (np.arange(p, dtype=np.int64) * 2 * s)[:, None]
            lev["row_piv"] = base + Ipiv.numpy()
            lev["col_piv"] = base + s + Jpiv.numpy()
    struct._build_flat()


# ---------------------------------------------------------------------------
# Functional core (pure tensors, differentiable)
# ---------------------------------------------------------------------------

def _block_matrix(pair_fn, theta, xa, va, xb, vb):
    """Masked kernel block ``K[..., i, j] = k(xa[..., i], xb[..., j])``
    (0 where either point is padding)."""
    K = pair_fn(theta, xa[..., :, None, :], xb[..., None, :, :])
    return torch.where(va[..., :, None] & vb[..., None, :], K, 0.0)


# Bytes of kernel entries the leaf and skeleton assemblies evaluate at once
# (:func:`_chunks`). Eager torch materializes every temporary of the pair
# function, and under the Hutchinson gradient's ``jvp`` its tangents too,
# one per parameter, so the live set is about ten times the entries being
# evaluated, times the parameters plus one. Unbounded, one f32 Hutchinson
# evaluation at n = 1e6 (2048 leaves of 489) needs more than an 80 GB
# card; the n = 1e5 paths (512 leaves of 196: 79 MB in f32, 157 MB in f64)
# stay one chunk.
_CHUNK_BYTES = 256 * 2 ** 20


def _chunks(count, item_bytes):
    """Slices of ``count`` items of ``item_bytes`` each, at most
    ``_CHUNK_BYTES`` a slice (one slice when they all fit)."""
    size = max(1, _CHUNK_BYTES // item_bytes)
    return [slice(i, min(i + size, count)) for i in range(0, count, size)]


def _cat(parts, dim=0):
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=dim)


# The dtype of the SMW cascade (the finer-inverse-applied factors, the
# cores, their inverses and log-determinants, and every level of a solve)
# and of the skeleton interpolants' ridge systems, whatever the working
# dtype. The working dtype keeps the bulk: the kernel entries, the leaf
# grams, the leaf Cholesky kernel and its triangular solves, and the
# gradient's forward-mode pass. A float32 cascade is not stable at depth:
# at bench.py's n = 1e6 (11 levels) a float32 GP on an H100 reads a
# factorization self-check residual of 4e5 and a likelihood 2.5e3 (relative)
# off bench.py's anchor with it, 3e-3 and 2e-5 with this one
# (``chip_smoke.py --cascade-dtype``): the SMW cores are ill-conditioned at
# every level, and the float32 ridge floor (100 eps_f32) also cuts the
# smooth kernel's interpolants short. The JAX package's TPU has no float64
# and keeps both in float32.
_CASCADE = torch.float64


def ridge_gram(M, ridge_floor=None):
    """``G = M^T M + lam I`` — the ridge-regularized skeleton gram.

    One half of the project's CUR design invariant: the interpolant must
    be the ridge pseudo-inverse of ``M`` solved against the PROJECTED
    right-hand side ``M^T R`` (see :func:`_lowrank_rows_t`). ``lam`` scales
    with ``trace(G)/c`` (relative eps ridge) plus an absolute floor —
    ``ridge_floor`` carries the ``tol_abs`` semantics (singular directions
    below it are damped; G holds squared singular values, hence the
    square). ``M``: ``(..., c, c)``.
    """
    finfo = torch.finfo(M.dtype)
    c = M.shape[-1]
    eps = 100.0 * finfo.eps
    G = torch.einsum("...ki,...kj->...ij", M, M)
    abs_floor = float(finfo.eps)
    if ridge_floor is not None:
        abs_floor = max(abs_floor, float(ridge_floor) ** 2)
    lam = (
        eps * torch.diagonal(G, dim1=-2, dim2=-1).sum(-1)[..., None] / c
        + abs_floor
    )
    return G + lam[..., None] * torch.eye(c, dtype=M.dtype, device=M.device)


def _enter(struct, t):
    """A replicated tensor as it enters this rank's row-local work (see
    ``parallel.collectives.replicated``); itself when unsharded."""
    return t if struct.shard is None else replicated(t, struct.shard.group)


def _rows(struct, t):
    """This rank's rows of a padded-row array (``(n_pad, ...)``)."""
    if struct.shard is None:
        return t
    return t[struct.row0:struct.row0 + struct.nloc]


def _rowsum(struct, x):
    """Sums over the row axis, reduced over the ranks holding its rows."""
    return x if struct.shard is None else struct.shard.sum(x)


def _lowrank_rows_t(pair_fn, theta, xpad, valid, struct):
    """Skeleton (CUR) factors of EVERY level's sibling couplings in the
    row layout: ``[Z_l, ...]``, each ``(c, nloc)`` over this rank's rows,
    holding ``C = K[left, J]`` (sampled kernel columns) on each pair's
    left rows and the ridge-regularized interpolant ``Q = K[I, right]^T M
    G^{-1}`` on its right rows, so ``A12 ~= C Q^T``. The kernel entries of
    all levels are one batched evaluation and the interpolation solves
    one batched solve per level.

    The ridge acts as a smooth truncated pseudo-inverse (couplings are
    often numerically rank-deficient; a QR triangular solve would amplify
    the null directions) and its absolute floor keeps exactly-zero
    couplings (fully-padded siblings) at 0 instead of NaN. The ridge
    systems are solved in ``_CASCADE`` (float64) and the interpolants
    returned in the working dtype. ``xpad`` and ``valid`` hold every
    padded row (the pivots may lie on any rank's).
    """
    flat = struct.flat
    if flat is None:
        return []
    c = flat["c"]
    dev = xpad.device
    rp = struct.index("rp_all", dev)
    cp = struct.index("cp_all", dev)
    xI, vI = xpad[rp], valid[rp]                # (P, c, d), (P, c)
    xJ, vJ = xpad[cp], valid[cp]
    M = _block_matrix(pair_fn, theta, xI, vI, xJ, vJ).to(_CASCADE)
    G = ridge_gram(M, struct.ridge_floor)                    # (P, c, c)

    # E[j, t] = k(x[row t], x[pivot j of row t's pair and half]) -> (c, T);
    # by kernel symmetry a right row's K[I, right]^T entries are
    # K(x_right_row, x_I)
    rows = struct.index("rows_loc", dev)
    tab = struct.index("piv_tab", dev)
    pid = struct.index("pid_loc", dev)
    parts = []
    for sl in _chunks(rows.shape[0], c * xpad.element_size()):
        ra, rb = rows[sl], tab[pid[sl]]          # (t,), (t, c)
        Es = pair_fn(theta, xpad[ra][None, :, :], xpad[rb].transpose(0, 1))
        parts.append(torch.where(valid[ra][None, :] & valid[rb].T, Es, 0.0))
    E = _cat(parts, dim=1)

    out = []
    po, nloc = flat["pair_offset"], struct.nloc
    for li, v in enumerate(struct.views):
        Zb = E[:, li * nloc:(li + 1) * nloc].reshape(c, v["np"], v["nh"],
                                                     v["sl"])
        halves = [Zb[:, :, h] for h in range(v["nh"])]   # (c, np, sl)
        if v["h0"] + v["nh"] == 2:       # right rows: interpolate
            a = po[li] + v["p0"]
            Ml, Gl = M[a:a + v["np"]], G[a:a + v["np"]]
            # Solve with the PROJECTED right-hand side M^T R (which lies
            # in range(M)): precomputing G^{-1} M^T and multiplying by R
            # later is mathematically identical but numerically injects
            # ~eps/lam null-space noise (design invariant).
            rhs = torch.einsum("pkc,kps->pcs", Ml,
                               halves[-1].to(_CASCADE))
            Q = _RidgeSolve.apply(Gl, rhs)[0]
            halves[-1] = Q.transpose(0, 1).to(E.dtype)
        out.append(torch.stack(halves, dim=2).reshape(c, nloc))
    return out


def _all_lowrank_t(pair_fn, theta, xpad, valid, struct):
    """The skeleton factors of :func:`_lowrank_rows_t` of an unsharded
    structure as ``[(Ct, Qt), ...]`` per level, each transposed ``(c, p,
    s)``."""
    out = []
    for lev, Z in zip(struct.levels,
                      _lowrank_rows_t(pair_fn, theta, xpad, valid, struct)):
        Zb = Z.reshape(lev["c"], lev["p"], 2, lev["s"])
        out.append((Zb[:, :, 0], Zb[:, :, 1]))
    return out


@contextlib.contextmanager
def _cusolver_lu(A):
    """cuSOLVER's and cuBLAS's routines for the LU calls inside on the
    CUDA batch ``A``. PyTorch's default factors a large batch of small
    matrices with MAGMA's batched LU, which synchronizes the device (a
    host wait, and a CUDA graph capture refuses it)."""
    if not A.is_cuda:
        yield
        return
    before = torch.backends.cuda.preferred_linalg_library()
    torch.backends.cuda.preferred_linalg_library("cusolver")
    try:
        yield
    finally:
        torch.backends.cuda.preferred_linalg_library(before)


class _RidgeSolve(torch.autograd.Function):
    """``(X, LU, pivots)``: ``X = G^{-1} B`` for the batch of ridge systems
    ``G`` ``(p, c, c)``, factored by :func:`_cusolver_lu`'s routines and
    solved as PyTorch's default solves (cuBLAS's batched ``getrs``, which
    the preference would give the solve too, swaps rows a column at a
    time: it took the quasi-periodic configuration's graphed value and
    gradient from 68.5 to 178.9 ms a call on an H100).
    No read of the device's error flag: a singular system gives a
    non-finite likelihood, as in the JAX package. Its derivatives are
    ``torch.linalg.solve``'s own, on the same factors; a backward that
    builds a graph (``create_graph``, ``torch.func``) factors ``G^T``
    again, as ``solve``'s does, so that higher derivatives hold."""

    generate_vmap_rule = True

    @staticmethod
    def forward(G, B):
        with _cusolver_lu(G):
            LU, piv, _ = torch.linalg.lu_factor_ex(G)
        return torch.linalg.lu_solve(LU, piv, B), LU, piv

    @staticmethod
    def setup_context(ctx, inputs, output):
        X, LU, piv = output
        ctx.mark_non_differentiable(LU, piv)
        ctx.save_for_backward(inputs[0], X, LU, piv)
        ctx.save_for_forward(X, LU, piv)

    @staticmethod
    def backward(ctx, gX, *_):
        G, X, LU, piv = ctx.saved_tensors
        if torch.is_grad_enabled():
            gB = _RidgeSolve.apply(G.mT, gX)[0]
        else:
            gB = torch.linalg.lu_solve(LU, piv, gX, adjoint=True)
        return -(gB @ X.mT), gB

    @staticmethod
    def jvp(ctx, dG, dB):
        X, LU, piv = ctx.saved_tensors
        return torch.linalg.lu_solve(LU, piv, dB - dG @ X), None, None


def _core_inv_slogdet(core):
    """Per-level SMW core inverse and log|det| (plain ``linalg``). The
    inverse does not read its error flag back to the host: a singular core
    gives a non-finite likelihood, which ``GP.log_prob_fn`` maps to
    ``-inf``, as the JAX package's ``inv`` does."""
    with _cusolver_lu(core):
        _, ld = torch.linalg.slogdet(core)
        return torch.linalg.inv_ex(core, check_errors=False)[0], ld


def _leaf_cholesky(pair_fn, theta, xb, vb, db):
    """Batched leaf assemble + Cholesky of ``K_leaf + diag``: the grams
    assembled in chunks of leaves (:func:`_chunks`), then one launch of
    the CUDA kernel over all of them on a CUDA tensor (the plain
    recurrence on a CPU tensor)."""
    B, m = vb.shape
    Kc = _cat([_block_matrix(pair_fn, theta, xb[sl], vb[sl], xb[sl], vb[sl])
               + torch.diag_embed(db[sl])
               for sl in _chunks(B, m * m * xb.element_size())])
    return _batched_cholesky(Kc)


def _leaf_solve_t(Lleaf, Xt):
    """``(L L^T)^{-1}`` applied to transposed multi-RHS ``Xt (k, n_pad)``
    as right-side triangular solves, ``X^T (L L^T)^{-1} =
    (X^T L^{-T}) L^{-1}``, so every buffer keeps the long axis minor."""
    B, m, _ = Lleaf.shape
    k = Xt.shape[0]
    Xb = Xt.reshape(k, B, m).transpose(0, 1)              # (B, k, m)
    z1 = torch.linalg.solve_triangular(
        Lleaf.mT, Xb, upper=True, left=False
    )                                                     # X^T L^{-T}
    z2 = torch.linalg.solve_triangular(
        Lleaf, z1, upper=False, left=False
    )                                                     # ... L^{-1}
    return z2.transpose(0, 1).reshape(k, B * m)


def _half_dots(struct, li, Ut, Xt):
    """Per sibling pair and half of level ``li``, the sums over the half's
    rows of ``U[c, row] X[k, row]``: ``(p', 2, c, k)`` for transposed
    ``Ut (c, nloc)`` and ``Xt (k, nloc)``. A level whose pairs this rank
    holds whole gives its own ``p' = np`` pairs; a coarser one gives all
    ``p`` pairs, replicated, from every rank's partial sums."""
    v = struct.views[li]
    c, k = Ut.shape[0], Xt.shape[0]
    shape = (v["np"], v["nh"], v["sl"])
    D = torch.einsum("cphs,kphs->phck", Ut.reshape((c,) + shape),
                     Xt.reshape((k,) + shape))
    if v["whole"]:
        return D
    p = struct.levels[li]["p"]
    D = torch.nn.functional.pad(
        D, (0, 0, 0, 0, v["h0"], 1 - v["h0"], v["p0"], p - 1 - v["p0"]))
    return struct.shard.sum(D)


def _half_apply(struct, li, Tt, Y):
    """The transpose of :func:`_half_dots`: each row of pair ``p``, half
    ``h`` gets ``sum_c T[c, row] Y[p, h, c, k]``; returns ``(k, nloc)``."""
    v = struct.views[li]
    if not v["whole"]:
        Y = _enter(struct, Y)[v["p0"]:v["p0"] + 1, v["h0"]:v["h0"] + 1]
    c = Tt.shape[0]
    out = torch.einsum("cphs,phck->kphs",
                       Tt.reshape(c, v["np"], v["nh"], v["sl"]), Y)
    return out.reshape(Y.shape[-1], struct.nloc)


def _factor_apply_inv_t(Zt, Tt, core_inv, struct, li, Xt):
    """Apply ``F_l^{-1} = I - W (I + Z^T W)^{-1} Z^T`` to transposed
    ``Xt (k, nloc)`` (SMW, batched over the level's sibling pairs)."""
    c = struct.levels[li]["c"]
    D = _half_dots(struct, li, Zt, Xt)         # [P^T x_left, Q^T x_right]
    y = torch.einsum("pcd,pdk->pck", core_inv,
                     torch.cat([D[:, 1], D[:, 0]], dim=1))
    return Xt - _half_apply(struct, li, Tt,
                            torch.stack([y[:, :c], y[:, c:]], dim=1))


def hodlr_factor(pair_fn, theta, xpad, valid, diag_pad, struct):
    """Factorize ``K_compressed + diag`` level-by-level.

    Returns ``(factors, logdet)`` with ``factors = {"Lleaf": (B, m, m),
    "levels": [(Zt, Tt, core_inv), ...]}``: ``Zt`` the raw and ``Tt`` the
    finer-inverse-applied skeleton factors, transposed ``(c_l, n_pad)``,
    and ``core_inv`` the inverted SMW cores ``(p_l, 2c_l, 2c_l)``. The
    leaf factors are in the working dtype; the levels and ``logdet`` in
    ``_CASCADE`` (float64).

    On a sharded structure (:meth:`HODLRStructure.set_shard`) the factors
    are this rank's: its leaves, its ``(c_l, nloc)`` rows of each level
    factor, and the cores of the pairs it holds whole (all ``p_l`` cores,
    replicated, of a level whose pairs span ranks); ``logdet`` is the
    whole operator's on every rank.
    """
    m, L = struct.m, struct.L
    B = struct.nloc // m
    theta = _enter(struct, theta)

    # --- leaf boxes: batched assemble + Cholesky --------------------------
    xb = _rows(struct, xpad).reshape(B, m, -1)
    vb = _rows(struct, valid).reshape(B, m)
    db = _rows(struct, _enter(struct, diag_pad)).reshape(B, m)
    Lleaf = _leaf_cholesky(pair_fn, theta, xb, vb, db)
    logdet = 2.0 * torch.sum(
        torch.log(torch.diagonal(Lleaf, dim1=-2, dim2=-1)).to(_CASCADE)
    )
    logdet_shared = None    # the cores of levels whose pairs span ranks

    # --- raw skeleton factors, all levels assembled in one batch ----------
    with annotate("hodlr.skeletons"):
        Zs = _lowrank_rows_t(pair_fn, theta, xpad, valid, struct)

    # --- upward sweep: factor each level, update coarser factors ----------
    # each level's inverse hits ALL coarser levels' factors as one
    # concatenated multi-RHS application, in _CASCADE from the leaf solve on
    with annotate("hodlr.cascade"):
        if L:
            Tcat = _leaf_solve_t(Lleaf, torch.cat(Zs, dim=0)).to(_CASCADE)
            T = list(torch.split(Tcat, [Z.shape[0] for Z in Zs], dim=0))
        else:
            T = []
        Zs = [Z.to(_CASCADE) for Z in Zs]
        levels_out = [None] * L
        for li in range(L - 1, -1, -1):   # li = level index (0 = root split)
            c = struct.levels[li]["c"]
            # [P^T Ptilde, Q^T Qtilde] per pair
            D = _half_dots(struct, li, Zs[li], T[li])
            lower, upper = D[:, 0], D[:, 1]
            p = D.shape[0]
            eye = torch.eye(c, dtype=upper.dtype, device=upper.device).expand(
                p, c, c)
            core = torch.cat(
                [torch.cat([eye, upper], dim=-1),
                 torch.cat([lower, eye], dim=-1)],
                dim=-2,
            )                                                # (p, 2c, 2c)
            core_inv, ld = _core_inv_slogdet(core)
            if struct.views[li]["whole"]:
                logdet = logdet + torch.sum(ld)
            else:
                logdet_shared = torch.sum(ld) + (
                    0.0 if logdet_shared is None else logdet_shared)
            levels_out[li] = (Zs[li], T[li], core_inv)
            if li > 0:
                X = _factor_apply_inv_t(Zs[li], T[li], core_inv, struct, li,
                                        torch.cat(T[:li], dim=0))
                T[:li] = torch.split(X, [T[j].shape[0] for j in range(li)],
                                     dim=0)

    logdet = _rowsum(struct, logdet)
    if logdet_shared is not None:
        logdet = logdet + logdet_shared
    return {"Lleaf": Lleaf, "levels": levels_out}, logdet


def _solve_t(factors, struct, Xt):
    """``(K^{-1} X)^T`` on transposed multi-RHS ``Xt (k, n_pad)``:
    ``D^{-1}`` in the leaves' dtype, then ``F_L^{-1} ... F_1^{-1}``
    (finest first) in ``_CASCADE``, the dtype of the result."""
    Lleaf = factors["Lleaf"]
    Xt = _leaf_solve_t(Lleaf, Xt.to(Lleaf.dtype)).to(_CASCADE)
    for li in range(struct.L - 1, -1, -1):
        Zt, Tt, core_inv = factors["levels"][li]
        Xt = _factor_apply_inv_t(Zt, Tt, core_inv, struct, li, Xt)
    return Xt


def _as_t(X):
    return (X[None, :], True) if X.ndim == 1 else (X.T, False)


def _from_t(Yt, squeeze):
    return Yt[0] if squeeze else Yt.T


def hodlr_solve(factors, struct, X):
    """``K^{-1} X`` through the factor cascade. ``X``: ``(n_pad,)`` or
    ``(n_pad, k)`` (this rank's ``nloc`` rows on a sharded structure); the
    result in ``X``'s dtype."""
    Xt, squeeze = _as_t(X)
    return _from_t(_solve_t(factors, struct, Xt).to(X.dtype), squeeze)


def _matvec_factors_t(factors, struct, Xt):
    """Compressed matvec ``((K_bar + diag) X)^T`` rebuilt from the
    factorization itself, with no kernel re-assembly: the leaf blocks as
    ``L L^T`` (in the leaves' dtype) and the raw skeleton factors ``Z =
    [C, Q]`` per level; the result in ``_CASCADE``."""
    Lleaf = factors["Lleaf"]
    B, m, _ = Lleaf.shape
    k = Xt.shape[0]
    # X^T K_leaf = (X^T L) L^T per leaf box, long axis minor throughout
    Xb = Xt.to(Lleaf.dtype).reshape(k, B, m).transpose(0, 1)  # (B, k, m)
    t1 = torch.einsum("bkm,bmn->bkn", Xb, Lleaf)
    Yb = torch.einsum("bkn,bjn->bkj", t1, Lleaf)
    Yt = Yb.transpose(0, 1).reshape(k, B * m).to(_CASCADE)
    Xt = Xt.to(_CASCADE)
    for li in range(struct.L):
        Yt = Yt + _coupling_t(factors["levels"][li][0], Xt, struct, li)
    return Yt


def _coupling_t(Zt, Xt, struct, li):
    """Off-diagonal coupling of level ``li`` on transposed ``Xt``: left
    rows get ``C (Q^T x_right)``, right rows ``Q (C^T x_left)``."""
    D = _half_dots(struct, li, Zt, Xt)          # [C^T x_left, Q^T x_right]
    return _half_apply(struct, li, Zt, D.flip(1))


def hodlr_matvec_factors(factors, struct, X):
    """``(K_bar + diag) X`` from the factors (see
    :func:`_matvec_factors_t`)."""
    Xt, squeeze = _as_t(X)
    return _from_t(_matvec_factors_t(factors, struct, Xt).to(X.dtype),
                   squeeze)


def _matvec_t(pair_fn, theta, xpad, valid, diag_pad, struct, Xt,
              include_diag=True):
    """Structured matvec with the compressed matrix on transposed ``Xt
    (k, n_pad)``: batched leaf-block products plus per-level low-rank
    couplings, kernel entries assembled afresh at ``theta`` (so
    ``torch.func.jvp`` in ``theta`` gives ``dK_bar/dtheta`` products)."""
    m = struct.m
    B = struct.nloc // m
    k = Xt.shape[0]
    theta = _enter(struct, theta)
    xb = _rows(struct, xpad).reshape(B, m, -1)
    vb = _rows(struct, valid).reshape(B, m)
    if include_diag:
        db = _rows(struct, _enter(struct, diag_pad)).reshape(B, m)
    # X^T K (K symmetric): contract the row index, minor stays long; the
    # leaf grams assembled and applied a chunk of leaves at a time
    Xl = Xt.reshape(k, B, m).transpose(0, 1)             # (B, k, m)
    parts = []
    for sl in _chunks(B, m * m * xb.element_size()):
        Kc = _block_matrix(pair_fn, theta, xb[sl], vb[sl], xb[sl], vb[sl])
        if include_diag:
            Kc = Kc + torch.diag_embed(db[sl])
        parts.append(torch.einsum("bki,bij->bkj", Xl[sl], Kc))
    Yt = _cat(parts).transpose(0, 1).reshape(k, struct.nloc)
    for li, Zt in enumerate(
            _lowrank_rows_t(pair_fn, theta, xpad, valid, struct)):
        Yt = Yt + _coupling_t(Zt, Xt, struct, li)
    return Yt


def hodlr_matvec(pair_fn, theta, xpad, valid, diag_pad, struct, X,
                 include_diag=True):
    """Structured matvec with the *compressed* matrix ``K_bar (+ diag)``:
    O(N r log N)."""
    Xt, squeeze = _as_t(X)
    return _from_t(
        _matvec_t(pair_fn, theta, xpad, valid, diag_pad, struct, Xt,
                  include_diag),
        squeeze,
    )


def _refine(solve, matvec, Xt, steps, rowsum=lambda x: x):
    """Residual-minimizing refinement of ``solve`` against ``matvec``:
    ``z += omega F^{-1} r`` with the per-column ``omega = <r, K d> / <K d,
    K d>`` (GMRES(1) with the cascade as right preconditioner), so
    ``||r'|| <= ||r||`` even where the cascade's inverse is poor.
    ``rowsum`` completes the row sums of a sharded layout. Returns the
    refined ``Z``, the first residual ``Xt - K F^{-1} Xt`` and the first
    step's ``K d`` (``None`` without steps)."""
    Z = solve(Xt)
    R = R0 = Xt - matvec(Z)
    KD0 = None
    tiny = torch.finfo(Xt.dtype).tiny
    for _ in range(steps):
        D = solve(R)
        KD = matvec(D)
        if KD0 is None:
            KD0 = KD
        w = rowsum(torch.sum(R * KD, dim=1)) / torch.clamp_min(
            rowsum(torch.sum(KD * KD, dim=1)), tiny
        )
        Z = Z + w[:, None] * D
        R = R - w[:, None] * KD
    return Z, R0, KD0


def hodlr_solve_refined(pair_fn, theta, xpad, valid, diag_pad, struct,
                        factors, X, steps=1):
    """``hodlr_solve`` plus iterative refinement against the compressed
    operator rebuilt from the factors (see :func:`_refine`): each step
    costs one factor solve and one assembly-free matvec, and contracts the
    float32 cascade's forward error toward the matvec's rounding floor."""
    Xt, squeeze = _as_t(X)
    Z, _, _ = _refine(
        lambda V: _solve_t(factors, struct, V),
        lambda V: _matvec_factors_t(factors, struct, V),
        Xt, steps, lambda x: _rowsum(struct, x),
    )
    return _from_t(Z.to(X.dtype), squeeze)


def dK_products(pair_fn, theta, xpad, valid, diag_pad, struct, Vt):
    """``(dK_bar/dtheta_t) V`` for every theta direction ``t`` at once, on
    transposed ``Vt (k, n_pad)``: ``(T, k, n_pad)``.

    One forward-mode pass batched over the directions (``vmap`` of
    ``jvp``, as the JAX package does): the primal matvec runs once and
    only the tangent ops are batched. A Python loop of one ``jvp`` per
    direction recomputes the primal each time and took ~3x as long at
    n=1e5 on an H100."""

    def mv(th):
        return _matvec_t(pair_fn, th, xpad, valid, diag_pad, struct, Vt,
                         include_diag=False)

    eye = torch.eye(theta.shape[0], dtype=theta.dtype, device=theta.device)
    return torch.func.vmap(lambda e: torch.func.jvp(mv, (theta,), (e,))[1])(
        eye)


def _contract_dK(struct, left, dK):
    """The Hutchinson kernel gradient from the ``dK`` products of ``[a |
    u_1 .. u_P]`` (:func:`dK_products`, ``(T, 1 + P, nloc)``) and their
    left partners ``left = [a | l_1 .. l_P]`` (``(1 + P, nloc)``):

        1/2 a^T dK_t a - 1/2 mean_p l_p^T dK_t u_p ,

    summed in float64 over this rank's rows and reduced over the ranks."""
    f64 = torch.float64
    with torch.no_grad():
        sums = _rowsum(struct, torch.einsum("ki,tki->tk", left.to(f64),
                                            dK.to(f64)))
    return 0.5 * (sums[:, 0] - torch.mean(sums[:, 1:], dim=1))


def hodlr_loglike_and_grad_hutchinson(
    pair_fn, theta, xpad, valid, diag_pad, r_pad, struct, generator=None,
    num_probes=16, n_real=None, refine_steps=0, factors_logdet=None,
    probes=None,
):
    """Log-likelihood + gradient without reverse mode through the sweep.

    The exact-autograd gradient stores the O(L^2) ancestor-update chain;
    this path is forward-mode only:

      d ll / d theta_k = 1/2 a^T (dK/dth_k) a
                          - 1/2 E_u[(K^{-1}u)^T (dK/dth_k) u],

    with ``a = K^{-1} r`` and Rademacher probes ``u``; the ``dK`` products
    are one forward-mode pass of the compressed matvec over all theta
    directions (:func:`dK_products`).

    Probes come from ``probes`` (a ``(num_probes, n_pad)`` tensor or
    array, e.g. to share them with another implementation) or are drawn
    with the explicit ``generator`` (a ``torch.Generator`` on the data's
    device). ``refine_steps`` runs that many residual-minimizing
    refinement steps on the solves, and adds the gated trace correction
    of the log-determinant from the same residual pass. ``factors_logdet``
    optionally passes a precomputed ``(factors, logdet)`` from
    :func:`hodlr_factor`.

    On a sharded structure ``r_pad`` and ``probes`` hold every padded row
    (as ``valid`` does); each rank works on its own and the sums are
    reduced over the ranks.
    """
    n = struct.n if n_real is None else n_real
    dtype = r_pad.dtype
    theta = theta.detach()
    rowsum = lambda x: _rowsum(struct, x)
    with torch.no_grad():
        if factors_logdet is not None:
            factors, logdet = factors_logdet
        else:
            factors, logdet = hodlr_factor(
                pair_fn, theta, xpad, valid, diag_pad, struct
            )

        def solve(V):
            return _solve_t(factors, struct, V)

        def mvf(V):
            return _matvec_factors_t(factors, struct, V)

        if probes is None:
            if generator is None:
                raise ValueError(
                    "pass a torch.Generator (generator=) or the probe "
                    "vectors (probes=)"
                )
            bits = torch.randint(
                0, 2, (num_probes, struct.n_pad), generator=generator,
                device=r_pad.device,
            )
            probes = (2 * bits - 1).to(dtype)
        else:
            probes = torch.as_tensor(probes, dtype=dtype, device=r_pad.device)
            if probes.ndim != 2 or probes.shape[1] != struct.n_pad:
                raise ValueError(
                    "probes must have shape (num_probes, %d)" % struct.n_pad
                )
        probes = _rows(struct, (probes * valid[None, :]).T).T
        r_pad = _rows(struct, r_pad)
        rhs = torch.cat([r_pad[None, :], probes], dim=0)
        if refine_steps:
            # Two fixes from the same residual pass, both assembly-free:
            # 1. residual-minimizing refinement of the solves;
            # 2. a trace correction of the computed logdet: with F the
            #    factored inverse and E = K_bar F - I,
            #      log det K_bar ~= logdet + tr(E) - tr(E^2)/2,
            #    where tr(E) = -E_u[u^T r_u] over the probes (r_u the
            #    refinement residual) and tr(E^2) = E_u[u^T(r_u - K_bar F
            #    r_u)] reuses the first refinement direction's matvec.
            # The series only converges for spectral radius < 1, so the
            # correction is gated on the measured residual ratio.
            sol, R0, KD0 = _refine(solve, mvf, rhs, refine_steps, rowsum)
            trE = -torch.mean(rowsum(torch.sum(probes * R0[1:], dim=1)))
            trE2 = torch.mean(rowsum(
                torch.sum(probes * (R0 - KD0)[1:], dim=1)))
            rho2 = torch.mean(
                rowsum(torch.sum(R0[1:] ** 2, dim=1))
                / torch.clamp_min(rowsum(torch.sum(probes ** 2, dim=1)),
                                  1.0)
            )
            logdet = logdet + torch.where(
                rho2 < 0.25, trE - 0.5 * trE2, torch.zeros_like(trE)
            )
        else:
            sol = solve(rhs)
        # the solves and the likelihood in _CASCADE, the forward-mode
        # pass in the working dtype, the gradient's sums in float64
        quad = rowsum(torch.dot(r_pad.to(sol.dtype), sol[0]))
        ll = (-0.5 * (quad + logdet + n * _LOG_2PI)).to(dtype)
        alpha, Kinv_u = sol[0].to(dtype), sol[1:].to(dtype)
        av = torch.cat([alpha[None, :], probes], dim=0)

    dK_av_t = dK_products(pair_fn, theta, xpad, valid, diag_pad, struct,
                          av)                       # (T, 1 + P, n_pad)
    left = torch.cat([alpha[None, :], Kinv_u], dim=0)
    return ll, _contract_dK(struct, left, dK_av_t).to(dtype)


# ---------------------------------------------------------------------------
# Symmetric factorization K = W W^T
# ---------------------------------------------------------------------------

def _leaf_tri_solve_t(Lleaf, Xt, transpose):
    """``(L^{-1} X)^T`` (``transpose=False``) or ``(L^{-T} X)^T`` on
    transposed ``Xt (k, n_pad)``, per leaf box: right-side triangular
    solves ``X^T L^{-T}`` and ``X^T L^{-1}``."""
    B, m, _ = Lleaf.shape
    k = Xt.shape[0]
    Xb = Xt.reshape(k, B, m).transpose(0, 1)              # (B, k, m)
    if transpose:
        Y = torch.linalg.solve_triangular(Lleaf, Xb, upper=False,
                                          left=False)
    else:
        Y = torch.linalg.solve_triangular(Lleaf.mT, Xb, upper=True,
                                          left=False)
    return Y.transpose(0, 1).reshape(k, B * m)


def _leaf_mul_t(Lleaf, Xt, transpose):
    """``(L X)^T = X^T L^T`` (``transpose=False``) or ``(L^T X)^T = X^T L``
    on transposed ``Xt (k, n_pad)``, per leaf box."""
    B, m, _ = Lleaf.shape
    k = Xt.shape[0]
    Xb = Xt.reshape(k, B, m).transpose(0, 1)              # (B, k, m)
    Y = Xb @ (Lleaf if transpose else Lleaf.mT)
    return Y.transpose(0, 1).reshape(k, B * m)


def hodlr_factor_sym(pair_fn, theta, xpad, valid, diag_pad, struct):
    """Symmetric factorization ``K_compressed + diag = W W^T``, batched
    level by level.

    ``W = L_leaf G_L ... G_1`` with each ``G_l`` block-diagonal over the
    level's sibling pairs. Per pair, with ``Utilde = W_left^{-1} C`` and
    ``Vtilde = W_right^{-1} Q`` (the skeleton factors of
    :func:`_lowrank_rows_t` with every finer factor's inverse applied), the
    node is ``I + U S U^T`` for ``U = blkdiag(Utilde, Vtilde)`` and ``S =
    [[0, I], [I, 0]]``. Each half is orthonormalized by QR (``Utilde = Qu
    Ru``), the small core ``I + [[0, Ru Rv^T], [Rv Ru^T, 0]]`` is split by
    ``eigh`` with its eigenvalues floored at ``100 eps`` (the square root
    stays defined where rounding makes the core indefinite), and ``G =
    I + Qhat (S^{1/2} - I) Qhat^T`` with ``Qhat = blkdiag(Qu, Qv)``. ``G``
    is symmetric, so ``G^{-T} = G^{-1} = I + Qhat (S^{-1/2} - I)
    Qhat^T``.

    Returns ``({"Lleaf", "levels": [(Qt, Msym, Minv), ...]}, logdet)``:
    ``Qt`` ``(c, n_pad)`` in the row layout of the skeleton factors (``Qu``
    on each pair's left rows, ``Qv`` on its right rows), ``Msym = S^{1/2}
    - I`` and ``Minv = S^{-1/2} - I`` ``(p, 2c, 2c)``, and ``logdet = log
    det K`` from the leaf Cholesky diagonals and the cores' eigenvalues.
    The QR and eigenvector signs cancel in ``Qhat M Qhat^T``, so ``W``
    itself is unique given the skeletons.

    On a sharded structure the factors are this rank's, as in
    :func:`hodlr_factor`: its leaves, its ``(c, nloc)`` rows of each
    ``Qt``, and the cores of the pairs it holds whole (all ``p`` of a level
    whose pairs span ranks, whose QR and ``eigh`` run on every rank on the
    gathered level); ``logdet`` is the whole operator's on every rank.
    """
    m, L = struct.m, struct.L
    B = struct.nloc // m
    theta = _enter(struct, theta)
    xb = _rows(struct, xpad).reshape(B, m, -1)
    vb = _rows(struct, valid).reshape(B, m)
    db = _rows(struct, _enter(struct, diag_pad)).reshape(B, m)
    Lleaf = _leaf_cholesky(pair_fn, theta, xb, vb, db)
    logdet = 2.0 * torch.sum(
        torch.log(torch.diagonal(Lleaf, dim1=-2, dim2=-1))
    )
    logdet_shared = None    # the cores of levels whose pairs span ranks
    levels_out = [None] * L
    if L:
        # C (left rows) and Q (right rows) of a level take the same W^{-1}
        # sweep, the leaf solve now and each G^{-1} as it is created (fine
        # to coarse): a finer node never mixes the two halves of a coarser
        # pair, so one row-layout factor carries both
        Zs = _lowrank_rows_t(pair_fn, theta, xpad, valid, struct)
        widths = [Z.shape[0] for Z in Zs]
        T = list(torch.split(
            _leaf_tri_solve_t(Lleaf, torch.cat(Zs, dim=0), False), widths,
            dim=0))
    floor = 100.0 * torch.finfo(diag_pad.dtype).eps
    for li in range(L - 1, -1, -1):   # li = level index (0 = root split)
        Qt, Msym, Minv, ld = _sym_node(struct, li, T[li], floor)
        if struct.views[li]["whole"]:
            logdet = logdet + ld
        else:
            logdet_shared = ld + (
                0.0 if logdet_shared is None else logdet_shared)
        levels_out[li] = (Qt, Msym, Minv)
        if li > 0:
            # G^{-1} hits the tilde factors of every coarser level
            X = _sym_apply_t(struct, li, Qt, Minv, torch.cat(T[:li], dim=0))
            T[:li] = torch.split(X, widths[:li], dim=0)

    logdet = _rowsum(struct, logdet)
    if logdet_shared is not None:
        logdet = logdet + logdet_shared
    return {"Lleaf": Lleaf, "levels": levels_out}, logdet


def _sym_node(struct, li, Tt, floor):
    """The symmetric node of level ``li`` from its tilde factors ``Tt``
    (``(c, nloc)``, row layout): ``(Qt, Msym, Minv, logdet)``, ``logdet``
    the sum of the log eigenvalues over the level's pairs. A level whose
    pairs span ranks is gathered whole (``c x n_pad``, no more than one
    level factor) and factored on every rank; each keeps its rows of
    ``Qt``."""
    v, lev = struct.views[li], struct.levels[li]
    s, c = lev["s"], lev["c"]
    p = v["np"]
    if not v["whole"]:
        Tt = struct.shard.gather(Tt, dim=1)
        p = lev["p"]
    Tb = Tt.reshape(c, p, 2, s)
    Qu, Ru = torch.linalg.qr(Tb[:, :, 0].permute(1, 2, 0))   # (p, s, c)
    Qv, Rv = torch.linalg.qr(Tb[:, :, 1].permute(1, 2, 0))
    cross = Ru @ Rv.mT                                      # Ru Rv^T
    dtype, dev = Tt.dtype, Tt.device
    zero = torch.zeros((p, c, c), dtype=dtype, device=dev)
    eye2 = torch.eye(2 * c, dtype=dtype, device=dev)
    core = eye2 + torch.cat(
        [torch.cat([zero, cross], dim=-1),
         torch.cat([cross.mT, zero], dim=-1)], dim=-2)
    evals, evecs = torch.linalg.eigh(core)
    evals = torch.clamp_min(evals, floor)
    sq = torch.sqrt(evals)
    Msym = (evecs * sq[:, None, :]) @ evecs.mT - eye2
    Minv = (evecs / sq[:, None, :]) @ evecs.mT - eye2
    Qt = torch.stack([Qu, Qv], dim=1).permute(3, 0, 1, 2).reshape(
        c, p * 2 * s)
    if not v["whole"]:
        Qt = _enter(struct, Qt)[:, struct.row0:struct.row0 + struct.nloc]
    # det G = det S^{1/2}, and log det K = 2 log det W
    return Qt, Msym, Minv, torch.sum(torch.log(evals))


def _sym_apply_t(struct, li, Qt, M, Xt):
    """Apply the symmetric node ``I + Qhat M Qhat^T`` of level ``li``
    (block-diagonal per pair, ``Qhat = blkdiag(Qu, Qv)`` in the row layout
    ``Qt``) to transposed ``Xt (k, nloc)``; the per-pair ``Qhat^T X`` of
    a level whose pairs span ranks is reduced over them
    (:func:`_half_dots`)."""
    c = struct.levels[li]["c"]
    D = _half_dots(struct, li, Qt, Xt)          # [Qu^T x_left, Qv^T x_right]
    y = torch.einsum("pcd,pdk->pck", M, torch.cat([D[:, 0], D[:, 1]], dim=1))
    return Xt + _half_apply(struct, li, Qt,
                            torch.stack([y[:, :c], y[:, c:]], dim=1))


def _sqrt_matvec_t(sym_factors, struct, Xt, transpose=False):
    """``(W X)^T`` or ``(W^T X)^T`` on transposed ``Xt (k, n_pad)`` (this
    rank's ``nloc`` rows on a sharded structure). ``W = L G_L ... G_1``:
    the root node first and the leaf factor last; the transpose takes
    ``L^T`` first and the nodes fine to coarse."""
    Lleaf = sym_factors["Lleaf"]
    L = len(struct.levels)
    if transpose:
        Xt = _leaf_mul_t(Lleaf, Xt, True)
        order = range(L - 1, -1, -1)
    else:
        order = range(L)
    for li in order:
        Qt, Msym, _ = sym_factors["levels"][li]
        Xt = _sym_apply_t(struct, li, Qt, Msym, Xt)
    if not transpose:
        Xt = _leaf_mul_t(Lleaf, Xt, False)
    return Xt


def _sqrt_solve_t(sym_factors, struct, Xt, transpose=False):
    """``(W^{-1} X)^T`` or ``(W^{-T} X)^T`` on transposed ``Xt``:
    ``W^{-1} = G_1^{-1} ... G_L^{-1} L^{-1}`` (the leaf solve first, nodes
    fine to coarse) and ``W^{-T} = L^{-T} G_L^{-1} ... G_1^{-1}``, each
    ``G_l^{-1}`` the stored ``I + Qhat (S^{-1/2} - I) Qhat^T``."""
    Lleaf = sym_factors["Lleaf"]
    L = len(struct.levels)
    if transpose:
        order = range(L)
    else:
        Xt = _leaf_tri_solve_t(Lleaf, Xt, False)
        order = range(L - 1, -1, -1)
    for li in order:
        Qt, _, Minv = sym_factors["levels"][li]
        Xt = _sym_apply_t(struct, li, Qt, Minv, Xt)
    if transpose:
        Xt = _leaf_tri_solve_t(Lleaf, Xt, True)
    return Xt


def hodlr_sqrt_matvec(sym_factors, struct, X, transpose=False):
    """``W X`` (or ``W^T X``) through the symmetric cascade. ``X``:
    ``(n_pad,)`` or ``(n_pad, k)`` (this rank's ``nloc`` rows on a sharded
    structure)."""
    Xt, squeeze = _as_t(X)
    return _from_t(_sqrt_matvec_t(sym_factors, struct, Xt, transpose),
                   squeeze)


def hodlr_sqrt_solve(sym_factors, struct, X, transpose=False):
    """``W^{-1} X`` (or ``W^{-T} X``) through the symmetric cascade;
    ``K^{-1} = W^{-T} W^{-1}``. ``X``: ``(n_pad,)`` or ``(n_pad, k)`` (this
    rank's ``nloc`` rows on a sharded structure)."""
    Xt, squeeze = _as_t(X)
    return _from_t(_sqrt_solve_t(sym_factors, struct, Xt, transpose),
                   squeeze)


# ---------------------------------------------------------------------------
# One value and gradient of loglike_fn as a CUDA graph
# ---------------------------------------------------------------------------

# calls of a HODLRSolver.loglike_fn function served by a replay of the
# solver's CUDA graph, and captures of that graph, failed ones included
# (read them as ``george_tpu_torch.solvers.hodlr.graph_replays`` and
# ``graph_captures``)
graph_replays = 0
graph_captures = 0


def _value_and_grad(f, args):
    """``(f(*args), *df/dargs)`` by one eager forward and one reverse sweep
    of plain autograd. Its reverse sweep solves with the forward's LU
    factors (``linalg_lu_solve``); a differentiable one (``torch.func``,
    which builds a graph of the gradient) calls ``linalg_solve`` again in
    the backward of ``slogdet``, whose error check reads the device."""
    with torch.enable_grad():
        args = [a.detach().requires_grad_(True) for a in args]
        value = f(*args)
        grads = torch.autograd.grad(value, args)
    return (value.detach(),) + tuple(grads)


def _one_grad_transform():
    """Whether the caller runs under plain autograd or exactly one
    ``torch.func.grad`` level: not under ``vmap`` (the samplers' chains,
    which run eagerly) and not under a nested transform (a second
    derivative, which the graph does not hold)."""
    level = torch._C._functorch.maybe_current_level()
    return level is None or (
        level == 1 and torch._C._functorch.peek_interpreter_stack().key()
        == torch._C._functorch.TransformType.Grad)


class _LoglikeGraph(object):
    """One value and gradient of ``f(theta_k, diag, r)``, the eager
    likelihood of :meth:`HODLRSolver.loglike_fn`, captured in a CUDA graph
    at the shapes, dtypes and device of ``args``: the kernels eager
    autograd runs, in its order, replayed with no Python between them.

    On a side stream: one eager warm-up, so that library handles,
    workspaces and the structure's device index tables exist before the
    capture; the capture; then one replay at the warm-up's inputs, which
    has to give the warm-up's answers to within rounding (``sqrt(eps)`` of
    the largest entry), or the constructor raises: a capture that missed
    work never answers. The warm-up's cached blocks are released after
    (they belong to the side stream, which nothing uses again); the
    graph's memory pool stays reserved while the graph lives. ``key`` is
    what the graph was captured for. The capture records the leaf
    kernel's launches without running them, so it leaves
    ``ops.chol.chol_kernel_launches`` as it found it, and each replay adds
    them (``launches``)."""

    @staticmethod
    def holds(args):
        """Whether a graph can hold a call at ``args``: CUDA tensors."""
        return all(a.is_cuda for a in args)

    def __init__(self, f, key, args):
        self.key = key
        self.inputs = [a.detach().clone() for a in args]
        dev = self.inputs[0].device
        stream = torch.cuda.Stream(dev)
        current = torch.cuda.current_stream(dev)
        stream.wait_stream(current)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(stream):
            want = _value_and_grad(f, self.inputs)
        before = _chol.chol_kernel_launches
        try:
            with torch.cuda.graph(self.graph, stream=stream):
                self.outputs = _value_and_grad(f, self.inputs)
        finally:
            # a capture that fails raises before the context restores the
            # caller's stream
            torch.cuda.set_stream(current)
            self.launches = _chol.chol_kernel_launches - before
            _chol.chol_kernel_launches = before
        self._replay()
        names = ("value", "theta_k gradient", "diag gradient", "r gradient")
        for name, got, ref in zip(names, self.outputs, want):
            gap = float((got - ref).abs().max() / ref.abs().max())
            if not gap <= math.sqrt(torch.finfo(ref.dtype).eps):
                raise RuntimeError("the replayed %s is %.3g (relative) off "
                                   "the eager one" % (name, gap))
        del want
        torch.cuda.empty_cache()

    def _replay(self):
        self.graph.replay()
        _chol.chol_kernel_launches += self.launches

    def run(self, args):
        """The value and gradients at ``args``: copies into the captured
        inputs, one replay, copies of the outputs."""
        for buf, a in zip(self.inputs, args):
            buf.copy_(a)
        self._replay()
        return tuple(o.clone() for o in self.outputs)


class _GraphedLoglike(torch.autograd.Function):
    """``loglike(theta_k, diag, r)`` whose value and gradients come
    together from the solver's graph
    (:meth:`HODLRSolver._graph_value_and_grad`). The forward returns
    ``(value, d/dtheta_k, d/ddiag, d/dr)``; the backward scales the three
    by the value's cotangent. It holds no second derivative: a backward
    that builds a graph under plain autograd (``create_graph=True``)
    raises, where nested ``torch.func`` transforms never reach it.
    Arguments: ``(solver, eager, theta_k, diag, r)``."""

    @staticmethod
    def forward(solver, eager, theta_k, diag, r):
        return solver._graph_value_and_grad(eager, (theta_k, diag, r))

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mark_non_differentiable(*output[1:])
        ctx.save_for_backward(*output[1:])

    @staticmethod
    def backward(ctx, g, *_):
        if (torch.is_grad_enabled()
                and torch._C._functorch.maybe_current_level() is None):
            raise RuntimeError(
                "HODLRSolver.loglike_fn's CUDA graph holds first derivatives "
                "only: take higher ones with torch.func (torch.func.hessian), "
                "whose nested transforms run the sweeps eagerly")
        return (None, None) + tuple(g * t for t in ctx.saved_tensors)


# ---------------------------------------------------------------------------
# Solver class (george-compatible protocol)
# ---------------------------------------------------------------------------

class HODLRSolver(object):
    """Hierarchical solver with the george HODLR surface.

    :param kernel: the covariance kernel.
    :param min_size: leaf box size.
    :param rank: skeleton rank per off-diagonal block; if ``None``, derived
        from ``tol``.
    :param tol: target relative accuracy; mapped to a static rank.
    :param tol_abs: absolute floor of the skeleton interpolation ridge.
    :param seed: pivot RNG seed.
    :param sort: Morton-sort inputs host-side for compressibility (on the
        kernel's ``sort_axes`` where it has them, as ``LCMKernel`` does).
    :param verbose: print the ``hodlr.aca_pivots`` (the host ACA walk),
        ``hodlr.compute`` (the factorization) and ``hodlr.self_check``
        spans (they are registered in ``diagnostics`` either way) and,
        under ``debug``, the self-check's numbers.
    :param debug: run the factorization self-check on every compute and
        measure the compression error against the exact kernel; a GP with
        a matrix-free gradient also compares it with the dense one.
    :param sym: factor ``K = W W^T`` (:func:`hodlr_factor_sym`) and solve
        through ``W^{-T} W^{-1}``; the Hutchinson gradient then uses the
        symmetric probes ``W^{-T} u``.
    :param knn: neighbor-guided skeleton pivots from the ``knn`` nearest
        neighbors of each point (``compute(..., nns=)`` passes a neighbor
        matrix instead).
    :param grad_mode: ``"exact"`` (autograd through :meth:`loglike_fn`) or
        ``"hutchinson"`` (matrix-free, :meth:`gradient_terms`);
        ``compute_grad=True`` selects the latter.
    :param pivots: ``"aca"`` (kernel-adaptive, chosen at compute-time
        theta) or ``"fps"`` (geometry only).
    :param refine_steps: refinement steps on every solve; ``"auto"`` is
        one step in float32 at n >= 2e5.
    :param device: torch device the factorization lives on (default
        ``"cuda"``; pass ``"cpu"`` explicitly on a host without a card).
    :param dtype: working dtype (default ``torch.float64``).
    :param mesh: a one-dimensional ``torch.distributed`` ``DeviceMesh``
        (``parallel.chain_mesh()``) to split the rows over: every rank of
        the mesh runs the same calls with the same data, holds a
        contiguous block of whole leaves (its leaf Cholesky is one launch
        of its own leaves) and the levels whose sibling pairs tile the
        ranks; a coarser level's per-pair sums are ``all_reduce``d, and
        the log-determinant and results are whole on every rank. The
        likelihood, its exact and Hutchinson gradients, ``log_prob_fn``
        (under the samplers' ``vmap`` too), solves, matvecs, ``predict``
        and the symmetric factorization (``sym=True``, ``apply_sqrt``,
        ``GP.sample``, ``apply_inverse_sym_W(_transpose)``) run sharded;
        when the leaf count does not split over the ranks it warns and
        runs unsharded.
    """

    matrix_free = False

    # configurations already residual-checked in this process. The check
    # costs a solve and a compressed matvec, too much for every recompute
    # of an optimizer loop; its failure mode (an unsuitable kernel family)
    # is mostly a property of the configuration, but the threshold depends
    # on theta (a length scale grown past the domain turns a decaying
    # kernel effectively non-decaying), so the key holds a per-parameter
    # e-fold bucket: a new regime re-triggers the check once
    _checked_configs = set()

    def __init__(self, kernel, min_size=64, rank=None, tol=0.1,
                 tol_abs=None, seed=42, sort=True, verbose=False,
                 debug=False, compute_grad=False, sym=False, knn=None,
                 grad_mode="exact", num_probes=16, mesh=None,
                 pivots="aca", refine_steps="auto", device="cuda",
                 dtype=torch.float64, **kwargs):
        if mesh is not None and not hasattr(mesh, "get_group"):
            raise TypeError("mesh must be a torch.distributed DeviceMesh "
                            "(george_tpu_torch.parallel.chain_mesh)")
        self.mesh = mesh
        self._shard = None
        self.kernel = kernel
        self.min_size = int(min_size)
        if rank is None:
            if tol >= 1e-2:
                rank = 16
            elif tol >= 1e-4:
                rank = 24
            elif tol >= 1e-6:
                rank = 32
            elif tol >= 1e-8:
                rank = 48
            else:
                rank = 64
        self.rank = int(rank)
        self.seed = int(seed)
        self.sort = bool(sort)
        self.verbose = bool(verbose)
        self.debug = bool(debug)
        self.sym = bool(sym)
        self.knn = None if knn is None else int(knn)
        self.tol_abs = None if tol_abs is None else float(tol_abs)
        if pivots not in ("aca", "fps"):
            raise ValueError("pivots must be 'aca' or 'fps'")
        self.pivots = pivots
        if compute_grad:
            grad_mode = "hutchinson"
        if grad_mode not in ("exact", "hutchinson"):
            raise ValueError("grad_mode must be 'exact' or 'hutchinson'")
        self.grad_mode = grad_mode
        self.matrix_free = grad_mode == "hutchinson"
        self.num_probes = int(num_probes)
        if refine_steps != "auto":
            refine_steps = int(refine_steps)
        self.refine_steps = refine_steps
        self.device = torch.device(device)
        self.dtype = dtype
        self.computed = False
        self.log_determinant = None
        self._struct = None
        self._factors = None
        self._perm = None
        self._sym_factors = None
        self._sym_theta = None
        # the CUDA graph of loglike_fn (_LoglikeGraph), the compute it
        # belongs to, and whether a capture failed on this solver
        self._graph = None
        self._generation = 0
        self._graph_refused = False

    def _tensor(self, a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64)).to(
            device=self.device, dtype=self.dtype
        )

    # -- setup -------------------------------------------------------------

    def compute(self, x, yerr=0.0, nns=None, **kwargs):
        # the symmetric factors and the graph belong to the previous points
        # and theta
        self._sym_factors = None
        self._sym_theta = None
        self._graph = None
        self._generation += 1
        x = as_points(x)
        n = len(x)
        yerr2 = np.atleast_1d(np.asarray(yerr, dtype=np.float64)) ** 2
        if yerr2.size == 1:
            yerr2 = yerr2 * np.ones(n)
        # a kernel with a label column (the LCM task id) orders and
        # partitions on its geometric axes only: ordered on the label, the
        # coarse couplings would be full-domain cross-task blocks, not
        # low-rank ones
        sa = getattr(self.kernel, "sort_axes", None)
        x_geom = x if sa is None else x[:, list(sa)]
        self._perm = (
            morton_sort_samples(x_geom) if self.sort
            else np.arange(n, dtype=np.int64)
        )
        self._perm_t = torch.as_tensor(self._perm, device=self.device)
        xs = x[self._perm]
        # a rectangular kNN matrix asks for neighbor-guided pivots; CSR
        # tuples, ragged listings and bare triggers are sparse-solver
        # structures, which the hierarchical solver ignores
        if nns is not None and (
            isinstance(nns, tuple) or np.isscalar(nns)
            or np.asarray(nns).dtype == object or np.ndim(nns) != 2
        ):
            nns = None
        if nns is None and self.knn:
            nns = knn_indices(x, self.knn)
        nns_sorted = None
        if nns is not None:
            # neighbor lists arrive in the original point order: map rows
            # and entries into the sorted layout
            nns = np.asarray(nns, dtype=np.int64)
            pos = np.empty(n, dtype=np.int64)
            pos[self._perm] = np.arange(n, dtype=np.int64)
            mapped = np.where(nns >= 0, pos[np.clip(nns, 0, n - 1)], -1)
            nns_sorted = mapped[self._perm]
        st = build_structure(
            n, min_size=self.min_size, rank=self.rank, seed=self.seed,
            x_sorted=x_geom[self._perm], nns=nns_sorted,
            ridge_floor=self.tol_abs,
        )
        xpad = np.concatenate(
            [xs, np.repeat(xs[-1:], st.n_pad - n, axis=0)], axis=0
        )
        valid = np.zeros(st.n_pad, dtype=bool)
        valid[:n] = True
        if self.pivots == "aca" and nns_sorted is None and st.L > 0:
            # kernel-adaptive skeletons at the compute-time theta, chosen
            # on the host in float64 (see select_aca_pivots); the
            # factorization stays exact-in-theta for autograd
            with timer("hodlr.aca_pivots", verbose=self.verbose):
                select_aca_pivots(self.kernel.pair_fn,
                                  self.kernel.parameter_vector, xpad, valid,
                                  st)
        diag_pad = np.ones(st.n_pad)
        diag_pad[:n] = yerr2[self._perm]
        self._shard = self._split_rows(st)

        self._struct = st
        self._x = x
        self._xpad = self._tensor(xpad)
        self._valid = torch.as_tensor(valid, device=self.device)
        self._diag_pad = self._tensor(diag_pad)
        self._theta = self._tensor(self.kernel.parameter_vector)
        refine = self.refine_steps
        if refine == "auto":
            refine = int(self.dtype == torch.float32 and n >= 200_000)
        self._refine_eff = refine
        factor = hodlr_factor_sym if self.sym else hodlr_factor
        with timer("hodlr.compute", verbose=self.verbose) as tm:
            with torch.no_grad():
                factors, logdet = tm.sync(factor(
                    self.kernel.pair_fn, self._theta, self._xpad,
                    self._valid, self._diag_pad, st,
                ))
        if not bool(torch.isfinite(logdet)):
            raise np.linalg.LinAlgError(
                "HODLR factorization failed (non-finite log-determinant)"
            )
        self._factors = factors
        if self.sym:
            # the main factors are the symmetric cascade: share them with
            # the sqrt / sym-W surface
            self._sym_factors = factors
            self._sym_theta = np.array(self.kernel.parameter_vector)
        self.log_determinant = float(logdet)
        self.computed = True
        with timer("hodlr.self_check", verbose=self.verbose):
            self._factorization_self_check()

    def _split_rows(self, st):
        """Split ``st``'s rows over the mesh (``None``: unsharded). Every
        rank adopts rank 0's skeleton pivots, so all ranks factor one
        structure."""
        shard = row_shard(self.mesh)
        if shard is None:
            return None
        if (st.n_pad // st.m) % shard.world:
            warnings.warn(
                "HODLRSolver: %d leaves do not split evenly over the "
                "%d-rank mesh; running unsharded. Choose min_size so that "
                "the leaf count (a power of two) is a multiple of the mesh "
                "size to distribute." % (st.n_pad // st.m, shard.world),
                RuntimeWarning)
            return None
        if st.L:
            piv = np.concatenate([np.concatenate([lv["row_piv"],
                                                  lv["col_piv"]], axis=1)
                                  for lv in st.levels])
            piv = broadcast(torch.as_tensor(piv, device=self.device),
                            shard.group).cpu().numpy()
            a = 0
            for lv in st.levels:
                lv["row_piv"] = piv[a:a + lv["p"], :lv["c"]]
                lv["col_piv"] = piv[a:a + lv["p"], lv["c"]:]
                a += lv["p"]
            st._build_flat()
        st.set_shard(shard)
        return shard

    def _gather(self, Z):
        """Whole rows from this rank's block of them."""
        return Z if self._shard is None else self._shard.gather(Z)

    def _factorization_self_check(self):
        """One-probe residual ``|K_bar (K_bar^{-1} v) - v| / |v|`` against
        the compressed operator, so that skeleton truncation does not
        enter, only instability of the factorization. It runs once per
        configuration and theta regime in a process (``_checked_configs``),
        and on every compute under ``debug``, which also measures the
        compression error ``|K_bar v - K v| / |K v|`` against the exact
        kernel.

        The weak-admissibility SMW cascade is numerically unstable for
        non-decaying kernels (Linear, Polynomial or DotProduct dominated
        covariances): the couplings rival the block diagonal and the SMW
        cores become singular to working precision, while the compressed
        operator itself stays accurate. That failure is detected here and
        reported with a warning."""
        self.factor_residual = None     # not measured on memoized computes
        self.compression_error = None   # measured only under debug
        theta = np.asarray(self.kernel.parameter_vector, dtype=np.float64)
        if np.isfinite(theta).all():
            # e-fold buckets: most parameters live in log space
            key = (
                tuple(self.kernel.get_parameter_names()),
                type(self.kernel).__name__,
                len(self._perm), self.min_size, self.rank,
                str(self.dtype).split(".")[-1],
                tuple(np.floor(theta).astype(np.int64).tolist()),
            )
            if key in HODLRSolver._checked_configs and not self.debug:
                return
            HODLRSolver._checked_configs.add(key)
        # a non-finite theta has no bucket: never memoized, always checked
        rng = np.random.default_rng(self.seed + 7)
        v = rng.standard_normal(len(self._perm))
        z = self.apply_inverse(v)
        r = float(np.linalg.norm(self.apply_forward(z) - v)
                  / np.linalg.norm(v))
        self.factor_residual = r
        if self.debug:
            zb = self.apply_forward(v)
            ze = self._exact_matvec(v)
            self.compression_error = float(
                np.linalg.norm(zb - ze) / np.linalg.norm(ze))
            if self.verbose:
                print("HODLR debug: compression rel err %.3e; "
                      "factorization residual %.3e"
                      % (self.compression_error, self.factor_residual))
        tol = 1e-6 if self.dtype == torch.float64 else 1e-2
        if r > tol:
            warnings.warn(
                "HODLR factorization self-check failed: relative solve "
                "residual %.2e against the compressed operator. The "
                "weak-admissibility SMW cascade is numerically unstable "
                "for non-decaying kernels (Linear/Polynomial/DotProduct"
                "-dominated covariances) — log-likelihoods and solves "
                "from this factorization are unreliable; use BasicSolver "
                "(or, for compact-support kernels, SparseSolver) "
                "instead." % r,
                stacklevel=3,
            )

    def _exact_matvec(self, v, chunk=4096):
        """Exact ``(K + diag) v`` in the original point order, by dense row
        blocks of ``chunk`` rows on the solver's device in float64: O(n^2)
        operations in O(n * chunk) memory."""
        f64 = torch.float64
        x = torch.as_tensor(self._x, dtype=f64, device=self.device)
        theta = torch.as_tensor(self.kernel.parameter_vector, dtype=f64,
                                device=self.device)
        n = len(x)
        d = torch.empty(n, dtype=f64, device=self.device)
        d[torch.as_tensor(self._perm, device=self.device)] = (
            self._diag_pad[:n].to(f64))
        v = torch.as_tensor(np.asarray(v, dtype=np.float64),
                            device=self.device)
        out = torch.empty(n, dtype=f64, device=self.device)
        with torch.no_grad():
            for i in range(0, n, chunk):
                rows = self.kernel.gram(theta, x[i:i + chunk], x)
                out[i:i + chunk] = rows @ v
        return (out + d * v).cpu().numpy()

    def _base_solve_t(self, factors, Yt):
        """One pass of the factored inverse on transposed ``Yt``: the SMW
        cascade, or ``W^{-T} W^{-1}`` when ``sym``."""
        st = self._struct
        if self.sym:
            return _sqrt_solve_t(factors, st,
                                 _sqrt_solve_t(factors, st, Yt),
                                 transpose=True)
        return _solve_t(factors, st, Yt)

    def _solve(self, Y):
        """``K^{-1} Y`` on padded device RHS ``(n_pad, k)``, with
        ``_refine_eff`` steps of plain refinement ``Z += F^{-1}(Y - K_bar
        Z)`` against the compressed matvec assembled at the compute-time
        theta (around either cascade)."""
        st = self._struct
        with torch.no_grad():
            Yt = _rows(st, Y).T
            Z = self._base_solve_t(self._factors, Yt)
            for _ in range(self._refine_eff):
                R = Yt - _matvec_t(self.kernel.pair_fn, self._theta,
                                   self._xpad, self._valid, self._diag_pad,
                                   st, Z.to(Yt.dtype))
                Z = Z + self._base_solve_t(self._factors, R)
            return self._gather(Z.T.to(Yt.dtype))

    # -- pure fused surface -------------------------------------------------

    def loglike_fn(self):
        """Pure ``f(theta_kernel, diag, r) -> log-likelihood`` through the
        hierarchical factorization (differentiable end-to-end); ``diag``
        and ``r`` are tensors in the original point order. It composes with
        ``torch.func.vmap`` and ``grad``: under ``vmap`` over chains the leaf
        Cholesky of every chain is one kernel launch.

        A call that takes :meth:`_graph_route` (a gradient on the card,
        outside ``vmap``, unsharded) gets its value and gradients from one
        CUDA graph of the forward and reverse sweeps, captured at its first
        such call after each ``compute`` and replayed after; every other
        call runs the sweeps eagerly."""
        st = self._struct
        pair = self.kernel.pair_fn
        perm = torch.as_tensor(self._perm, device=self.device)
        xpad, valid = self._xpad, self._valid
        n = st.n
        generation = self._generation

        def eager(theta_k, diag, r):
            theta_k = backward_mark(theta_k)
            with annotate("hodlr.factor"):
                diag_pad, r_pad = self._pad_diag_rhs(perm, diag, r)
                factors, logdet = hodlr_factor(
                    pair, theta_k, xpad, valid, diag_pad, st
                )
            with annotate("hodlr.solve"):
                r_pad = _rows(st, _enter(st, r_pad))
                z = hodlr_solve(factors, st, r_pad)
                quad = _rowsum(st, torch.dot(r_pad, z))
            out = (-0.5 * (quad + logdet + n * _LOG_2PI)).to(r_pad.dtype)
            return backward_mark(out, "hodlr.backward")

        def loglike(theta_k, diag, r):
            args = (theta_k, diag, r)
            if self._graph_route(generation, args):
                return _GraphedLoglike.apply(self, eager, *args)[0]
            return eager(*args)

        return loglike

    def _pad_diag_rhs(self, perm, diag, r):
        """``diag`` and ``r`` (original order) in the solver's sorted,
        padded order: padding rows get a unit diagonal and a zero
        residual."""
        pad = self._struct.n_pad - self._struct.n
        return (torch.cat([diag[perm], diag.new_ones(pad)]),
                torch.cat([r[perm], r.new_zeros(pad)]))

    def _graph_route(self, generation, args):
        """Whether a call of the ``loglike_fn`` function made at compute
        ``generation`` takes the CUDA graph at ``args``: a gradient is
        asked for (grad mode on, an input that requires one) by plain
        autograd or one ``torch.func.grad``, not under ``vmap``
        (:func:`_one_grad_transform`); every input is a CUDA tensor
        (:meth:`_LoglikeGraph.holds`); the rows are not split over a mesh (its collectives
        stay out of graphs); the function belongs to the latest compute;
        and no capture failed on this solver."""
        return (not self._graph_refused and generation == self._generation
                and self._struct.shard is None and torch.is_grad_enabled()
                and _LoglikeGraph.holds(args)
                and any(a.requires_grad for a in args)
                and _one_grad_transform())

    def _graph_value_and_grad(self, eager, args):
        """``(value, *gradients)`` of ``eager`` at ``args`` from this
        solver's graph, captured first where it has none at these dtypes,
        devices and shapes (``compute`` drops it). A capture that raises
        leaves the solver eager for good, with a warning; this call then
        runs the sweeps eagerly."""
        global graph_captures, graph_replays
        key = tuple((a.dtype, a.device, tuple(a.shape)) for a in args)
        if self._graph is None or self._graph.key != key:
            self._graph = None
            graph_captures += 1
            try:
                self._graph = _LoglikeGraph(eager, key, args)
            except RuntimeError as err:
                self._graph_refused = True
                warnings.warn("HODLRSolver: the CUDA graph of the likelihood "
                              "and its gradient was not captured, so it "
                              "runs eagerly: %s" % err, RuntimeWarning)
                return _value_and_grad(eager, args)
        graph_replays += 1
        return self._graph.run(args)

    def residual_fn(self):
        """Pure ``f(theta_kernel, diag, r) -> |K_bar z - r| / |r|``, the
        relative solve residual of the fused factorization at ``theta``,
        with ``z`` its solve of ``r`` and ``K_bar`` the compressed operator
        assembled afresh at ``theta``.

        The fused ``loglike_fn`` never checks itself, so a chain that walks
        into a regime where the cascade's SMW cores go singular (a
        non-decaying kernel component growing dominant) would get wrong
        log-probabilities silently; evaluate this at the thetas a sampler
        visited (``GP.check_fused_thetas`` picks them) instead."""
        st = self._struct
        pair = self.kernel.pair_fn
        perm = torch.as_tensor(self._perm, device=self.device)
        xpad, valid = self._xpad, self._valid

        def norm(v):
            if st.shard is None:
                return torch.linalg.vector_norm(v)
            return torch.sqrt(_rowsum(st, torch.sum(v * v)))

        def residual(theta_k, diag, r):
            diag_pad, r_pad = self._pad_diag_rhs(perm, diag, r)
            factors, _ = hodlr_factor(pair, theta_k, xpad, valid, diag_pad,
                                      st)
            r_pad = _rows(st, _enter(st, r_pad))
            z = hodlr_solve(factors, st, r_pad)
            kz = hodlr_matvec(pair, theta_k, xpad, valid, diag_pad, st, z)
            return norm(kz - r_pad) / norm(r_pad)

        return residual

    # -- george protocol ----------------------------------------------------

    def _pad_rhs(self, y):
        st = self._struct
        y = np.asarray(y, dtype=np.float64)
        squeeze = y.ndim == 1
        Y = y[:, None] if squeeze else y
        pad = np.zeros((st.n_pad - st.n, Y.shape[1]))
        return self._tensor(np.concatenate([Y[self._perm], pad])), squeeze

    def _unpad(self, Z, squeeze):
        count_host_read()
        Z = Z[: self._struct.n].detach().cpu().numpy().astype(np.float64)
        out = np.empty_like(Z)
        out[self._perm] = Z
        return out[:, 0] if squeeze else out

    def apply_inverse(self, y, in_place=False):
        Y, squeeze = self._pad_rhs(y)
        return self._unpad(self._solve(Y), squeeze)

    def solve_columns(self, R):
        """``K^{-1} R`` for columns ``R (n, k)`` in the original point
        order, on the solver's device in its dtype, staying there: the rows
        gathered into the sorted, padded order, :meth:`_solve` (whole rows
        on every rank under ``mesh=``), and scattered back."""
        st, perm = self._struct, self._perm_t
        pad = R.new_zeros((st.n_pad - st.n, R.shape[1]))
        Z = self._solve(torch.cat([R[perm], pad]))
        out = torch.empty_like(R)
        out[perm] = Z[:st.n]
        return out

    def dot_solve(self, y):
        Y, _ = self._pad_rhs(y)
        return float(torch.sum(Y * self._solve(Y)))

    def apply_forward(self, y, i=0):
        """Compressed matvec ``K_bar y`` (``i == 0``) or
        ``dK_bar/dtheta_{i-1} y`` via ``torch.func.jvp`` through it."""
        Y, squeeze = self._pad_rhs(y)
        Y = _rows(self._struct, Y)
        theta = self._tensor(self.kernel.parameter_vector)

        def mv(th):
            return hodlr_matvec(self.kernel.pair_fn, th, self._xpad,
                                self._valid, self._diag_pad, self._struct, Y)

        if i == 0:
            with torch.no_grad():
                Z = mv(theta)
        else:
            tangent = torch.zeros_like(theta)
            tangent[i - 1] = 1.0
            _, Z = torch.func.jvp(mv, (theta,), (tangent,))
        return self._unpad(self._gather(Z.detach()), squeeze)

    def get_inverse(self):
        return self.apply_inverse(np.eye(self._struct.n))

    def get_full(self, i=0):
        """Dense reconstruction of ``K_bar + diag`` (``i == 0``) or
        ``dK_bar/dtheta_{i-1}``, for inspection at small N."""
        return self.apply_forward(np.eye(self._struct.n), i=i)

    def gradient_terms(self, alpha):
        """The matrix-free (``grad_mode='hutchinson'``) gradient terms for
        ``a = alpha`` (original point order): the kernel block ``1/2 a^T
        dK_t a - 1/2 mean_u[l_u^T dK_t r_u]`` over the kernel's full
        parameter vector, and ``diag(a a^T - K^{-1})`` from the same
        probes. The ``dK`` products of ``[a | r_u]`` are one forward-mode
        pass (:func:`dK_products`), contracted as
        :func:`hodlr_loglike_and_grad_hutchinson` does. The probes ``u``
        pair as ``r_u = u``, ``l_u = K^{-1} u``; under ``sym``, with ``K =
        W W^T``, as ``r_u = l_u = W^{-T} u``: a quadratic form in a
        symmetric operator, with half the variance, and ``E[l_u r_u^T] =
        K^{-1}`` either way."""
        st, f64 = self._struct, torch.float64
        alpha = np.asarray(alpha, dtype=np.float64)
        probes = np.random.default_rng(self.seed + 1).choice(
            [-1.0, 1.0], size=(st.n, self.num_probes))
        V = np.zeros((st.n_pad, 1 + self.num_probes))
        V[:st.n] = np.concatenate([alpha[:, None], probes], 1)[self._perm]
        V = torch.as_tensor(V, device=self.device)    # [a | u], float64
        U = V[:, 1:].to(self.dtype)
        valid = _rows(st, self._valid)
        with torch.no_grad():
            a = _rows(st, V[:, :1]).T
            if self.sym:
                self._ensure_sym()
                left = _sqrt_solve_t(self._sym_factors, st, _rows(st, U).T,
                                     True)
                right = left = left.to(f64) * valid
            else:
                right = _rows(st, V[:, 1:]).T
                left = _rows(st, self._solve(U)).T.to(f64) * valid
        dK = dK_products(self.kernel.pair_fn, self._theta, self._xpad,
                         self._valid, self._diag_pad, st,
                         torch.cat([a, right]).to(self.dtype))
        g_kernel = _contract_dK(st, torch.cat([a, left]), dK)
        with torch.no_grad():
            diag_Kinv = torch.mean(right * left, dim=0)
        diag_Kinv = self._unpad(self._gather(diag_Kinv[:, None]), True)
        count_host_read()
        return g_kernel.cpu().numpy(), alpha ** 2 - diag_Kinv

    # -- symmetric factor surface ----------------------------------------

    def _ensure_sym(self):
        """(Re)build the symmetric factors ``K = W W^T`` lazily, keyed on
        the kernel's current parameter vector."""
        theta = np.array(self.kernel.parameter_vector)
        if self._sym_factors is None or self._sym_theta is None or (
                not np.array_equal(theta, self._sym_theta)):
            with torch.no_grad():
                self._sym_factors, _ = hodlr_factor_sym(
                    self.kernel.pair_fn, self._tensor(theta), self._xpad,
                    self._valid, self._diag_pad, self._struct)
            self._sym_theta = theta

    def apply_sqrt(self, r):
        """``r @ W^T`` with ``K = W W^T`` from the symmetric factorization:
        rows of ``r`` ``(size, n)`` (or one row ``(n,)``) transported to
        prior draws in O(n r log n)."""
        self._ensure_sym()
        st = self._struct
        r = np.asarray(r, dtype=np.float64)
        squeeze = r.ndim == 1
        R = r[None, :] if squeeze else r               # (size, n)
        Z = np.zeros((R.shape[0], st.n_pad))
        Z[:, :st.n] = R[:, self._perm]
        Z = _rows(st, self._tensor(Z).T).T
        with torch.no_grad():
            out = _sqrt_matvec_t(self._sym_factors, st, Z)
        out = self._gather(out.T).T[:, :st.n].cpu().numpy().astype(
            np.float64)
        res = np.empty_like(out)
        res[:, self._perm] = out
        return res[0] if squeeze else res

    def _apply_sym_W(self, y, solve, transpose):
        self._ensure_sym()
        Y, squeeze = self._pad_rhs(y)
        fn = _sqrt_solve_t if solve else _sqrt_matvec_t
        with torch.no_grad():
            Z = fn(self._sym_factors, self._struct, _rows(self._struct, Y).T,
                   transpose)
        return self._unpad(self._gather(Z.T), squeeze)

    def apply_inverse_sym_W(self, y):
        """``W^{-1} y``; the columns of a matrix ``y`` independently."""
        return self._apply_sym_W(y, solve=True, transpose=False)

    def apply_inverse_sym_W_transpose(self, y):
        """``W^{-T} y``; the columns of a matrix ``y`` independently."""
        return self._apply_sym_W(y, solve=True, transpose=True)

    # pickling drops the device state and the mesh (a process group does
    # not serialize); a restored solver needs a compute
    def __getstate__(self):
        state = self.__dict__.copy()
        for k in ("_factors", "_xpad", "_valid", "_diag_pad", "_theta",
                  "_sym_factors", "_struct", "_perm_t", "_graph"):
            state.pop(k, None)
        state["_sym_theta"] = None
        state["computed"] = False
        state["mesh"] = None
        state["_shard"] = None
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self.__dict__.setdefault("_struct", None)
        self.__dict__.setdefault("_factors", None)
        self.__dict__.setdefault("_sym_factors", None)
        self.__dict__.setdefault("mesh", None)
        self.__dict__.setdefault("_shard", None)
        self.__dict__.setdefault("_graph", None)
        self.__dict__.setdefault("_generation", 0)
        self.__dict__.setdefault("_graph_refused", False)
