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
JAX package's row layout, HBM chunking of the leaf sweeps, width-bounded
ancestor-update groups and mesh-sharding pins were workarounds for the
TPU's memory and lane tiling and are not ported.

Gradients: the whole factorization is differentiable torch code, so
autograd through :meth:`HODLRSolver.loglike_fn` gives the exact gradient
of the compressed likelihood; :func:`hodlr_loglike_and_grad_hutchinson`
is the forward-mode, matrix-free alternative (exact quadratic terms,
Hutchinson traces) from ``torch.func.jvp`` of the compressed matvec.

Points are pre-sorted host-side (``neighbors.morton_sort_samples``) so
off-diagonal blocks are numerically low-rank; the skeleton pivots are
static indices chosen once per ``compute`` on the host.
"""

import math

import numpy as np
import torch

from ..neighbors import morton_sort_samples
from ..ops.chol import cholesky as _batched_cholesky
from .linalg import as_points

__all__ = ["HODLRSolver", "HODLRStructure", "build_structure",
           "select_aca_pivots", "hodlr_factor", "hodlr_solve",
           "hodlr_matvec", "hodlr_matvec_factors", "hodlr_solve_refined",
           "hodlr_loglike_and_grad_hutchinson", "ridge_gram"]

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

    ``pivots``: optional per-level ``(row_piv, col_piv)`` arrays of
    absolute padded-row indices, shape ``(p_l, c_l)`` each, to adopt
    instead of drawing farthest-point pivots (how
    ``convert.structure_from_arrays`` carries another structure's
    skeletons over).
    """

    def __init__(self, n, min_size=64, rank=32, seed=42, x_sorted=None,
                 ridge_floor=None, pivots=None):
        self.n = int(n)
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
        for lev in range(1, L + 1):
            s = self.n_pad >> lev
            p = 1 << (lev - 1)
            c = min(self.rank, s)
            blocks = xpad.reshape(p, 2, s, -1)
            vmask = vpad.reshape(p, 2, s)
            row_piv = _fps_pivots(blocks[:, 0], vmask[:, 0], c, rng)
            col_piv = _fps_pivots(blocks[:, 1], vmask[:, 1], c, rng)
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
            return
        c = self.rank
        rp_all = np.concatenate([lv["row_piv"] for lv in self.levels])
        cp_all = np.concatenate([lv["col_piv"] for lv in self.levels])
        pair_offset = np.cumsum([0] + [lv["p"] for lv in self.levels])
        rowsC, pairC, rowsR = [], [], []
        row_offset = [0]
        for li, lv in enumerate(self.levels):
            s, p = lv["s"], lv["p"]
            base = np.arange(p, dtype=np.int64)[:, None] * 2 * s
            left = (base + np.arange(s, dtype=np.int64)[None, :]).ravel()
            right = (
                base + s + np.arange(s, dtype=np.int64)[None, :]
            ).ravel()
            pid = (
                pair_offset[li]
                + np.repeat(np.arange(p, dtype=np.int64), s)
            )
            rowsC.append(left)
            rowsR.append(right)
            pairC.append(pid)
            row_offset.append(row_offset[-1] + p * s)
        self.flat = {
            "c": c,
            "rp_all": rp_all,                        # (P, c)
            "cp_all": cp_all,
            "rowsC": np.concatenate(rowsC),          # (T,)
            "rowsR": np.concatenate(rowsR),
            "pair_of_row": np.concatenate(pairC),
            "pair_offset": [int(v) for v in pair_offset],
            "row_offset": [int(v) for v in row_offset],
        }

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


def build_structure(n, min_size=64, rank=32, seed=42, x_sorted=None,
                    ridge_floor=None):
    return HODLRStructure(
        n, min_size=min_size, rank=rank, seed=seed, x_sorted=x_sorted,
        ridge_floor=ridge_floor,
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


def ridge_gram(M, ridge_floor=None):
    """``G = M^T M + lam I`` — the ridge-regularized skeleton gram.

    One half of the project's CUR design invariant: the interpolant must
    be the ridge pseudo-inverse of ``M`` solved against the PROJECTED
    right-hand side ``M^T R`` (see :func:`_all_lowrank_t`). ``lam`` scales
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


def _all_lowrank_t(pair_fn, theta, xpad, valid, struct):
    """Skeleton (CUR) factors for EVERY level's sibling couplings, with the
    kernel-entry assembly and the interpolation solves batched over all
    levels at once.

    Per pair, ``A12 ~= C @ Q^T``: ``C = K[left, J]`` sampled columns and
    ``Q = K[I, right]^T M G^{-1}`` the ridge-regularized interpolant. The
    ridge acts as a smooth truncated pseudo-inverse (couplings are often
    numerically rank-deficient; a QR triangular solve would amplify the
    null directions) and its absolute floor keeps exactly-zero couplings
    (fully-padded siblings) at 0 instead of NaN.

    Returns ``[(Ct, Qt), ...]`` per level, each transposed ``(c, p, s)``.
    """
    flat = struct.flat
    if flat is None:
        return []
    c = flat["c"]
    dev = xpad.device
    rp = struct.index("rp_all", dev)
    cp = struct.index("cp_all", dev)
    pid = struct.index("pair_of_row", dev)
    xI, vI = xpad[rp], valid[rp]                # (P, c, d), (P, c)
    xJ, vJ = xpad[cp], valid[cp]
    M = _block_matrix(pair_fn, theta, xI, vI, xJ, vJ)       # (P, c, c)
    G = ridge_gram(M, struct.ridge_floor)

    def rows_eval(rows_name, xP, vP):
        # E[j, t] = k(x[row t], x[pivot j of row t's pair]) -> (c, T)
        rows = struct.index(rows_name, dev)
        xa, va = xpad[rows], valid[rows]        # (T, d), (T,)
        xb, vb = xP[pid], vP[pid]               # (T, c, d), (T, c)
        E = pair_fn(theta, xa[None, :, :], xb.transpose(0, 1))
        return torch.where(va[None, :] & vb.T, E, 0.0)

    C_flat = rows_eval("rowsC", xJ, vJ)         # K[left, J] columns
    # kernel symmetry: K[I, right]^T rows are K(x_right_row, x_I)
    Rt_flat = rows_eval("rowsR", xI, vI)

    out = []
    ro, po = flat["row_offset"], flat["pair_offset"]
    for li, lev in enumerate(struct.levels):
        s, p = lev["s"], lev["p"]
        Ct = C_flat[:, ro[li]:ro[li + 1]].reshape(c, p, s)
        Rt = Rt_flat[:, ro[li]:ro[li + 1]].reshape(c, p, s)
        Ml = M[po[li]:po[li + 1]]
        Gl = G[po[li]:po[li + 1]]
        # Solve with the PROJECTED right-hand side M^T R (which lies in
        # range(M)): precomputing G^{-1} M^T and multiplying by R later is
        # mathematically identical but numerically injects ~eps/lam
        # null-space noise (design invariant).
        rhs = torch.einsum("pkc,kps->pcs", Ml, Rt)
        Qsol = torch.linalg.solve(Gl, rhs)                  # (p, c, s)
        out.append((Ct, Qsol.transpose(0, 1)))              # (c, p, s)
    return out


def _core_inv_slogdet(core):
    """Per-level SMW core inverse and log|det| (plain ``linalg``)."""
    _, ld = torch.linalg.slogdet(core)
    return torch.linalg.inv(core), ld


def _leaf_cholesky(pair_fn, theta, xb, vb, db):
    """Batched leaf assemble + Cholesky of ``K_leaf + diag``: the CUDA
    kernel on a CUDA tensor, the plain recurrence on a CPU tensor."""
    Kc = _block_matrix(pair_fn, theta, xb, vb, xb, vb) + torch.diag_embed(db)
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


def _factor_apply_inv_t(Zt, Tt, core_inv, p, s, c, Xt):
    """Apply ``F_l^{-1} = I - W (I + Z^T W)^{-1} Z^T`` to transposed
    ``Xt (k, n_pad)`` (SMW, batched over the level's sibling pairs)."""
    k = Xt.shape[0]
    Xb = Xt.reshape(k, p, 2, s)
    Zb = Zt.reshape(c, p, 2, s)
    Tb = Tt.reshape(c, p, 2, s)
    top = torch.einsum("cps,kps->pck", Zb[:, :, 1], Xb[:, :, 1])
    bot = torch.einsum("cps,kps->pck", Zb[:, :, 0], Xb[:, :, 0])
    y = torch.einsum(
        "pcd,pdk->pck", core_inv, torch.cat([top, bot], dim=1)
    )
    dx_l = torch.einsum("cps,pck->kps", Tb[:, :, 0], y[:, :c])
    dx_r = torch.einsum("cps,pck->kps", Tb[:, :, 1], y[:, c:])
    out = Xb - torch.stack([dx_l, dx_r], dim=2)
    return out.reshape(Xt.shape)


def hodlr_factor(pair_fn, theta, xpad, valid, diag_pad, struct):
    """Factorize ``K_compressed + diag`` level-by-level.

    Returns ``(factors, logdet)`` with ``factors = {"Lleaf": (B, m, m),
    "levels": [(Zt, Tt, core_inv), ...]}``: ``Zt`` the raw and ``Tt`` the
    finer-inverse-applied skeleton factors, transposed ``(c_l, n_pad)``,
    and ``core_inv`` the inverted SMW cores ``(p_l, 2c_l, 2c_l)``.
    """
    n_pad, m, L = struct.n_pad, struct.m, struct.L
    B = n_pad // m

    # --- leaf boxes: batched assemble + Cholesky --------------------------
    xb = xpad.reshape(B, m, -1)
    vb = valid.reshape(B, m)
    Lleaf = _leaf_cholesky(pair_fn, theta, xb, vb, diag_pad.reshape(B, m))
    logdet = 2.0 * torch.sum(
        torch.log(torch.diagonal(Lleaf, dim1=-2, dim2=-1))
    )

    # --- raw skeleton factors, all levels assembled in one batch ----------
    Zs = [
        torch.stack([Ct, Qt], dim=2).reshape(lev["c"], n_pad)
        for lev, (Ct, Qt) in zip(
            struct.levels, _all_lowrank_t(pair_fn, theta, xpad, valid,
                                          struct)
        )
    ]

    # --- upward sweep: factor each level, update coarser factors ----------
    # each level's inverse hits ALL coarser levels' factors as one
    # concatenated multi-RHS application
    if L:
        Tcat = _leaf_solve_t(Lleaf, torch.cat(Zs, dim=0))
        T = list(torch.split(Tcat, [Z.shape[0] for Z in Zs], dim=0))
    else:
        T = []
    levels_out = [None] * L
    for li in range(L - 1, -1, -1):   # li = level index (0 = root split)
        lev = struct.levels[li]
        s, p, c = lev["s"], lev["p"], lev["c"]
        Zb = Zs[li].reshape(c, p, 2, s)
        Tb = T[li].reshape(c, p, 2, s)
        P, Q = Zb[:, :, 0], Zb[:, :, 1]                  # (c, p, s)
        Pt, Qt_ = Tb[:, :, 0], Tb[:, :, 1]
        upper = torch.einsum("cps,dps->pcd", Q, Qt_)     # Q^T Qtilde
        lower = torch.einsum("cps,dps->pcd", P, Pt)      # P^T Ptilde
        eye = torch.eye(c, dtype=upper.dtype, device=upper.device).expand(
            p, c, c)
        core = torch.cat(
            [torch.cat([eye, upper], dim=-1),
             torch.cat([lower, eye], dim=-1)],
            dim=-2,
        )                                                # (p, 2c, 2c)
        core_inv, ld = _core_inv_slogdet(core)
        logdet = logdet + torch.sum(ld)
        levels_out[li] = (Zs[li], T[li], core_inv)
        if li > 0:
            X = _factor_apply_inv_t(Zs[li], T[li], core_inv, p, s, c,
                                    torch.cat(T[:li], dim=0))
            T[:li] = torch.split(X, [T[j].shape[0] for j in range(li)],
                                 dim=0)

    return {"Lleaf": Lleaf, "levels": levels_out}, logdet


def _solve_t(factors, struct, Xt):
    """``(K^{-1} X)^T`` on transposed multi-RHS ``Xt (k, n_pad)``:
    ``D^{-1}`` then ``F_L^{-1} ... F_1^{-1}`` (finest first)."""
    Xt = _leaf_solve_t(factors["Lleaf"], Xt)
    for li in range(struct.L - 1, -1, -1):
        lev = struct.levels[li]
        Zt, Tt, core_inv = factors["levels"][li]
        Xt = _factor_apply_inv_t(Zt, Tt, core_inv, lev["p"], lev["s"],
                                 lev["c"], Xt)
    return Xt


def _as_t(X):
    return (X[None, :], True) if X.ndim == 1 else (X.T, False)


def _from_t(Yt, squeeze):
    return Yt[0] if squeeze else Yt.T


def hodlr_solve(factors, struct, X):
    """``K^{-1} X`` through the factor cascade. ``X``: ``(n_pad,)`` or
    ``(n_pad, k)``."""
    Xt, squeeze = _as_t(X)
    return _from_t(_solve_t(factors, struct, Xt), squeeze)


def _matvec_factors_t(factors, struct, Xt):
    """Compressed matvec ``((K_bar + diag) X)^T`` rebuilt from the
    factorization itself, with no kernel re-assembly: the leaf blocks as
    ``L L^T`` and the raw skeleton factors ``Z = [C, Q]`` per level."""
    Lleaf = factors["Lleaf"]
    B, m, _ = Lleaf.shape
    k = Xt.shape[0]
    # X^T K_leaf = (X^T L) L^T per leaf box, long axis minor throughout
    Xb = Xt.reshape(k, B, m).transpose(0, 1)             # (B, k, m)
    t1 = torch.einsum("bkm,bmn->bkn", Xb, Lleaf)
    Yb = torch.einsum("bkn,bjn->bkj", t1, Lleaf)
    Yt = Yb.transpose(0, 1).reshape(k, B * m)
    for li, lev in enumerate(struct.levels):
        s, p, c = lev["s"], lev["p"], lev["c"]
        Zb = factors["levels"][li][0].reshape(c, p, 2, s)
        Yt = Yt + _coupling_t(Zb[:, :, 0], Zb[:, :, 1], Xt, p, s)
    return Yt


def _coupling_t(Ct, Qt, Xt, p, s):
    """Off-diagonal coupling of one level on transposed ``Xt``: left rows
    get ``C (Q^T x_right)``, right rows ``Q (C^T x_left)``."""
    k = Xt.shape[0]
    Xb = Xt.reshape(k, p, 2, s)
    qx = torch.einsum("cps,kps->pck", Qt, Xb[:, :, 1])
    px = torch.einsum("cps,kps->pck", Ct, Xb[:, :, 0])
    add_l = torch.einsum("cps,pck->kps", Ct, qx)
    add_r = torch.einsum("cps,pck->kps", Qt, px)
    return torch.stack([add_l, add_r], dim=2).reshape(Xt.shape)


def hodlr_matvec_factors(factors, struct, X):
    """``(K_bar + diag) X`` from the factors (see
    :func:`_matvec_factors_t`)."""
    Xt, squeeze = _as_t(X)
    return _from_t(_matvec_factors_t(factors, struct, Xt), squeeze)


def _matvec_t(pair_fn, theta, xpad, valid, diag_pad, struct, Xt,
              include_diag=True):
    """Structured matvec with the compressed matrix on transposed ``Xt
    (k, n_pad)``: batched leaf-block products plus per-level low-rank
    couplings, kernel entries assembled afresh at ``theta`` (so
    ``torch.func.jvp`` in ``theta`` gives ``dK_bar/dtheta`` products)."""
    n_pad, m = struct.n_pad, struct.m
    B = n_pad // m
    k = Xt.shape[0]
    xb = xpad.reshape(B, m, -1)
    vb = valid.reshape(B, m)
    Kc = _block_matrix(pair_fn, theta, xb, vb, xb, vb)
    if include_diag:
        Kc = Kc + torch.diag_embed(diag_pad.reshape(B, m))
    # X^T K (K symmetric): contract the row index, minor stays long
    Xl = Xt.reshape(k, B, m).transpose(0, 1)             # (B, k, m)
    Yb = torch.einsum("bki,bij->bkj", Xl, Kc)
    Yt = Yb.transpose(0, 1).reshape(k, n_pad)
    for lev, (Ct, Qt) in zip(
        struct.levels, _all_lowrank_t(pair_fn, theta, xpad, valid, struct)
    ):
        Yt = Yt + _coupling_t(Ct, Qt, Xt, lev["p"], lev["s"])
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


def _refine(solve, matvec, Xt, steps):
    """Residual-minimizing refinement of ``solve`` against ``matvec``:
    ``z += omega F^{-1} r`` with the per-column ``omega = <r, K d> / <K d,
    K d>`` (GMRES(1) with the cascade as right preconditioner), so
    ``||r'|| <= ||r||`` even where the cascade's inverse is poor."""
    Z = solve(Xt)
    R = Xt - matvec(Z)
    tiny = torch.finfo(Xt.dtype).tiny
    for _ in range(steps):
        D = solve(R)
        KD = matvec(D)
        w = torch.sum(R * KD, dim=1) / torch.clamp_min(
            torch.sum(KD * KD, dim=1), tiny
        )
        Z = Z + w[:, None] * D
        R = R - w[:, None] * KD
    return Z


def hodlr_solve_refined(pair_fn, theta, xpad, valid, diag_pad, struct,
                        factors, X, steps=1):
    """``hodlr_solve`` plus iterative refinement against the compressed
    operator rebuilt from the factors (see :func:`_refine`): each step
    costs one factor solve and one assembly-free matvec, and contracts the
    float32 cascade's forward error toward the matvec's rounding floor."""
    Xt, squeeze = _as_t(X)
    Z = _refine(
        lambda V: _solve_t(factors, struct, V),
        lambda V: _matvec_factors_t(factors, struct, V),
        Xt, steps,
    )
    return _from_t(Z, squeeze)


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
    """
    n = struct.n if n_real is None else n_real
    dtype = r_pad.dtype
    theta = theta.detach()
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
        probes = probes * valid[None, :]
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
            sol0 = solve(rhs)
            R0 = rhs - mvf(sol0)
            trE = -torch.mean(torch.sum(probes * R0[1:], dim=1))
            rho2 = torch.mean(
                torch.sum(R0[1:] ** 2, dim=1)
                / torch.clamp_min(torch.sum(probes ** 2, dim=1), 1.0)
            )
            sol, R, trE2 = sol0, R0, None
            tiny = torch.finfo(dtype).tiny
            for _ in range(refine_steps):
                D = solve(R)
                KD = mvf(D)
                if trE2 is None:
                    trE2 = torch.mean(
                        torch.sum(probes * (R0 - KD)[1:], dim=1)
                    )
                w = torch.sum(R * KD, dim=1) / torch.clamp_min(
                    torch.sum(KD * KD, dim=1), tiny
                )
                sol = sol + w[:, None] * D
                R = R - w[:, None] * KD
            logdet = logdet + torch.where(
                rho2 < 0.25, trE - 0.5 * trE2, torch.zeros_like(trE)
            )
        else:
            sol = solve(rhs)
        alpha, Kinv_u = sol[0], sol[1:]
        quad = torch.dot(r_pad, alpha)
        ll = -0.5 * (quad + logdet + n * _LOG_2PI)
        av = torch.cat([alpha[None, :], probes], dim=0)

    dK_av_t = dK_products(pair_fn, theta, xpad, valid, diag_pad, struct,
                          av)                       # (T, 1 + P, n_pad)
    quad_terms = 0.5 * torch.einsum("i,ti->t", alpha, dK_av_t[:, 0, :])
    trace_terms = 0.5 * torch.mean(
        torch.einsum("pi,tpi->tp", Kinv_u, dK_av_t[:, 1:, :]), dim=1
    )
    return ll, quad_terms - trace_terms


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
    :param sort: Morton-sort inputs host-side for compressibility.
    :param grad_mode: ``"exact"`` (autograd through :meth:`loglike_fn`) or
        ``"hutchinson"`` (matrix-free, :meth:`grad_log_likelihood`);
        ``compute_grad=True`` selects the latter.
    :param pivots: ``"aca"`` (kernel-adaptive, chosen at compute-time
        theta) or ``"fps"`` (geometry only).
    :param refine_steps: refinement steps on every solve; ``"auto"`` is
        one step in float32 at n >= 2e5.
    :param device: torch device the factorization lives on (default
        ``"cuda"``; pass ``"cpu"`` explicitly on a host without a card).
    :param dtype: working dtype (default ``torch.float64``).

    Not ported yet (they raise ``NotImplementedError``): ``sym=True``,
    ``mesh=``, ``knn=`` / kNN-guided pivots from ``nns``, and the
    factorization self-check behind ``debug=True``.
    """

    matrix_free = False

    def __init__(self, kernel, min_size=64, rank=None, tol=0.1,
                 tol_abs=None, seed=42, sort=True, debug=False, compute_grad=False, sym=False, knn=None,
                 grad_mode="exact", num_probes=16, mesh=None,
                 pivots="aca", refine_steps="auto", device="cuda",
                 dtype=torch.float64, **kwargs):
        for flag, name in ((sym, "sym=True"), (mesh is not None, "mesh="),
                           (knn is not None, "knn="),
                           (debug, "debug=True (the self-check)")):
            if flag:
                raise NotImplementedError(
                    "HODLRSolver(%s) is not ported to george_tpu_torch yet"
                    % name
                )
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

    def _tensor(self, a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64)).to(
            device=self.device, dtype=self.dtype
        )

    # -- setup -------------------------------------------------------------

    def compute(self, x, yerr=0.0, nns=None, **kwargs):
        x = as_points(x)
        n = len(x)
        yerr2 = np.atleast_1d(np.asarray(yerr, dtype=np.float64)) ** 2
        if yerr2.size == 1:
            yerr2 = yerr2 * np.ones(n)
        # a rectangular kNN matrix asks for neighbor-guided pivots; CSR
        # tuples, ragged listings and bare triggers are sparse-solver
        # structures, which the hierarchical solver ignores
        if nns is not None and not (
            isinstance(nns, tuple) or np.isscalar(nns)
            or np.asarray(nns).dtype == object or np.ndim(nns) != 2
        ):
            raise NotImplementedError(
                "kNN-guided HODLR pivots are not ported to george_tpu_torch "
                "yet"
            )
        self._perm = (
            morton_sort_samples(x) if self.sort
            else np.arange(n, dtype=np.int64)
        )
        xs = x[self._perm]
        st = build_structure(
            n, min_size=self.min_size, rank=self.rank, seed=self.seed,
            x_sorted=xs, ridge_floor=self.tol_abs,
        )
        xpad = np.concatenate(
            [xs, np.repeat(xs[-1:], st.n_pad - n, axis=0)], axis=0
        )
        valid = np.zeros(st.n_pad, dtype=bool)
        valid[:n] = True
        if self.pivots == "aca" and st.L > 0:
            # kernel-adaptive skeletons at the compute-time theta, chosen
            # on the host in float64 (see select_aca_pivots); the
            # factorization stays exact-in-theta for autograd
            select_aca_pivots(self.kernel.pair_fn,
                              self.kernel.parameter_vector, xpad, valid, st)
        diag_pad = np.ones(st.n_pad)
        diag_pad[:n] = yerr2[self._perm]

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
        with torch.no_grad():
            factors, logdet = hodlr_factor(
                self.kernel.pair_fn, self._theta, self._xpad, self._valid,
                self._diag_pad, st,
            )
        if not bool(torch.isfinite(logdet)):
            raise np.linalg.LinAlgError(
                "HODLR factorization failed (non-finite log-determinant)"
            )
        self._factors = factors
        self.log_determinant = float(logdet)
        self.computed = True

    def _solve(self, Y):
        """``K^{-1} Y`` on padded device RHS ``(n_pad, k)``, with
        ``_refine_eff`` steps of plain refinement ``Z += F^{-1}(Y - K_bar
        Z)`` against the compressed matvec assembled at the compute-time
        theta."""
        st = self._struct
        with torch.no_grad():
            Yt = Y.T
            Z = _solve_t(self._factors, st, Yt)
            for _ in range(self._refine_eff):
                R = Yt - _matvec_t(self.kernel.pair_fn, self._theta,
                                   self._xpad, self._valid, self._diag_pad,
                                   st, Z)
                Z = Z + _solve_t(self._factors, st, R)
            return Z.T

    # -- pure fused surface -------------------------------------------------

    def loglike_fn(self):
        """Pure ``f(theta_kernel, diag, r) -> log-likelihood`` through the
        hierarchical factorization (differentiable end-to-end); ``diag``
        and ``r`` are tensors in the original point order."""
        st = self._struct
        pair = self.kernel.pair_fn
        perm = torch.as_tensor(self._perm, device=self.device)
        xpad, valid = self._xpad, self._valid
        n, n_pad = st.n, st.n_pad

        def loglike(theta_k, diag, r):
            pad = n_pad - n
            diag_pad = torch.cat([diag[perm], diag.new_ones(pad)])
            r_pad = torch.cat([r[perm], r.new_zeros(pad)])
            factors, logdet = hodlr_factor(
                pair, theta_k, xpad, valid, diag_pad, st
            )
            z = hodlr_solve(factors, st, r_pad)
            quad = torch.dot(r_pad, z)
            return -0.5 * (quad + logdet + n * _LOG_2PI)

        return loglike

    # -- george protocol ----------------------------------------------------

    def _pad_rhs(self, y):
        st = self._struct
        y = np.asarray(y, dtype=np.float64)
        squeeze = y.ndim == 1
        Y = y[:, None] if squeeze else y
        pad = np.zeros((st.n_pad - st.n, Y.shape[1]))
        return self._tensor(np.concatenate([Y[self._perm], pad])), squeeze

    def _unpad(self, Z, squeeze):
        Z = Z[: self._struct.n].detach().cpu().numpy().astype(np.float64)
        out = np.empty_like(Z)
        out[self._perm] = Z
        return out[:, 0] if squeeze else out

    def apply_inverse(self, y, in_place=False):
        Y, squeeze = self._pad_rhs(y)
        return self._unpad(self._solve(Y), squeeze)

    def dot_solve(self, y):
        Y, _ = self._pad_rhs(y)
        return float(torch.sum(Y * self._solve(Y)))

    def apply_forward(self, y, i=0):
        """Compressed matvec ``K_bar y`` (``i == 0``) or
        ``dK_bar/dtheta_{i-1} y`` via ``torch.func.jvp`` through it."""
        Y, squeeze = self._pad_rhs(y)
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
        return self._unpad(Z, squeeze)

    def get_inverse(self):
        return self.apply_inverse(np.eye(self._struct.n))

    def get_full(self, i=0):
        """Dense reconstruction of ``K_bar + diag`` (``i == 0``) or
        ``dK_bar/dtheta_{i-1}``, for inspection at small N."""
        return self.apply_forward(np.eye(self._struct.n), i=i)

    def grad_log_likelihood(self, gp, x, alpha, unfrozen_mask):
        """Matrix-free GP gradient (``grad_mode='hutchinson'``): exact
        quadratic terms, Hutchinson-estimated traces, through this
        solver's jvp matvecs."""
        n = self._struct.n
        alpha = np.asarray(alpha)
        rng = np.random.default_rng(self.seed + 1)
        probes = rng.choice([-1.0, 1.0], size=(n, self.num_probes))
        probe_l, probe_r = self.apply_inverse(probes), probes

        nparam = int(self.kernel.full_size)
        kernel_grads = np.empty(nparam)
        for k in range(nparam):
            dK_alpha = self.apply_forward(alpha, k + 1)
            dK_u = self.apply_forward(probe_r, k + 1)
            quad_term = 0.5 * float(alpha @ dK_alpha)
            trace_term = 0.5 * float(
                np.mean(np.sum(probe_l * dK_u, axis=0))
            )
            kernel_grads[k] = quad_term - trace_term

        mean_g = []
        if len(gp.mean):
            mu_g = gp._call_mean_gradient(np.asarray(x))
            mean_g = list(np.dot(mu_g, alpha))
        wn_g = []
        if len(gp.white_noise):
            wn = gp._call_white_noise(np.asarray(x))
            wng = gp._call_white_noise_gradient(np.asarray(x))
            diag_Kinv = np.mean(probe_r * probe_l, axis=1)
            diag_A = alpha ** 2 - diag_Kinv
            wn_g = list(
                0.5 * np.sum((np.exp(wn) * diag_A)[None, :] * wng, axis=1)
            )
        kmask = gp.kernel.unfrozen_mask
        return np.array(mean_g + wn_g + list(kernel_grads[kmask]))
