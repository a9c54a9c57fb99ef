# -*- coding: utf-8 -*-
"""Compact-support sparse solver (PyTorch port of
``george_tpu/solvers/sparse.py``).

The sparse structure lives in a padded-neighbor (ELL) layout built from the
host-side radius query (``neighbors.radius_neighbors_csr``); on sorted 1-D
data the neighborhoods are contiguous and the structure is a band (DIA):

* ``(K + diag) Y`` from a kernel-entry table evaluated once per theta:
  on a band by the hand-written DIA kernel (``ops/dia.py``, the plain
  version on CPU tensors), otherwise by a gather and a per-row contraction
  (``ell_apply``, torch ops, as XLA ran it in the JAX package);
* solves by Jacobi-preconditioned conjugate gradients: a Python loop of
  the apply and one CG step (``ops/cg.py``: a hand-written CUDA kernel on
  CUDA tensors) that keeps the stopping test on the device, read to the
  host every ``CG_READ_EVERY`` steps;
* ``log_determinant`` by stochastic Lanczos quadrature (SLQ) over one
  ``(n, num_probes)`` block of Rademacher probes;
* gradients by ``d ll / d theta = 1/2 a^T (dK/dtheta) a
  - 1/2 tr(K^{-1} dK/dtheta)``, the trace Hutchinson-estimated with CG
  solves and the ``dK/dtheta`` products applied as tangent value tables
  (``torch.func.jvp`` of ``ell_values``) through the same apply.

On a band the default ``direct="auto"`` takes the exact block-tridiagonal
Cholesky of ``solvers/banded.py`` instead of CG and SLQ.

Under ``mesh=`` (a ``torch.distributed`` ``DeviceMesh``) the rows are split
over the ranks, as the JAX package shards them: the ELL tables (the band
is not taken) are padded to a multiple of the mesh size and each rank
holds its block of them, its rows of every vector and of the entry table;
the coordinates are replicated. Each matvec gathers the vector from all
ranks and computes its own rows, and the CG, Lanczos and gradient sums
are reduced over the ranks; the adjoints of the fused likelihood read the
gathered solutions at the global neighbour ids and keep their own rows.

The fused likelihood behind ``GP.log_prob_fn`` and the samplers
(``SparseSolver.loglike_fn``) is the exact banded one on the direct path;
on the iterative path it is CG with an implicit adjoint and SLQ with a
Hutchinson adjoint (``_CgSolve``, ``_SlqLogdet``), through the same apply.

"""

import numpy as np
import torch

from ..diagnostics import annotate, count_host_read
from ..neighbors import (
    knn_matrix_to_csr, normalize_nns, radius_neighbors_csr,
)
from ..ops.cg import cg_step, cg_workspace
from ..ops.dia import DiaOperator, dia_matvec
from ..parallel.collectives import replicated, row_shard
from .banded import (
    band_block_size, band_blocks, banded_cholesky, banded_loglike_fn,
    banded_solve, banded_sqrt_matvec,
)
from .linalg import as_points

__all__ = ["SparseSolver", "ell_from_csr", "ell_matvec", "ell_values",
           "ell_apply", "dia_apply", "banded_offsets", "banded_ell_tables",
           "cg_solve", "cg_diff_solve", "lanczos_fn_matvec", "pcg_solve",
           "slq_logdet"]

# iterations of :func:`pcg_solve` and :func:`cg_solve` on every path (a
# program counter)
cg_iteration_count = 0
# steps :func:`cg_solve` runs between two reads of its stopping test
CG_READ_EVERY = 8


def ell_from_csr(nbr_idx, row_ptr, pad_multiple=8):
    """Convert CSR neighbor lists to a padded ELL table.

    Returns ``(nbr, mask)``: ``nbr`` ``(n, k_max)`` int32 neighbor indices
    (padded entries point at row 0), ``mask`` ``(n, k_max)`` bool.
    """
    n = len(row_ptr) - 1
    counts = np.diff(row_ptr)
    k_max = int(counts.max()) if n else 0
    k_max = max(pad_multiple, -(-k_max // pad_multiple) * pad_multiple)
    nbr = np.zeros((n, k_max), dtype=np.int32)
    mask = np.zeros((n, k_max), dtype=bool)
    # entry t of the CSR stream lands at (row(t), t - row_start(row(t)))
    rows = np.repeat(np.arange(n, dtype=np.int64), counts)
    slots = np.arange(len(nbr_idx), dtype=np.int64) - np.repeat(
        np.asarray(row_ptr[:-1], dtype=np.int64), counts
    )
    nbr[rows, slots] = nbr_idx
    mask[rows, slots] = True
    return nbr, mask


def ell_values(pair_fn, theta, x, nbr, mask, rows=None):
    """Masked kernel-entry table ``vals[i, j] = k(x_i, x_nbr[i, j])``,
    shape ``(n, k_max)``; ``x`` ``(n, d)``, ``nbr`` an integer tensor and
    ``mask`` a bool tensor of the table's shape. ``rows`` (default ``x``)
    are the points of the table's rows when it holds only some of them."""
    rows = x if rows is None else rows
    vals = pair_fn(theta, rows[:, None, :], x[nbr])
    return torch.where(mask, vals, 0.0)


def ell_apply(vals, nbr, diag, y):
    """``(K + diag) y`` from a value table: one neighbor gather and one
    per-row contraction. ``y``: ``(n,)`` or ``(n, r)``."""
    squeeze = y.ndim == 1
    Y = y[:, None] if squeeze else y
    out = torch.einsum("ik,ikr->ir", vals, Y[nbr]) + diag[:, None] * Y
    return out[:, 0] if squeeze else out


def ell_matvec(pair_fn, theta, x, nbr, mask, diag, y):
    """``(K + diag) y`` with the entry table evaluated at ``theta`` (the
    form to differentiate in ``theta``)."""
    return ell_apply(ell_values(pair_fn, theta, x, nbr, mask), nbr, diag, y)


def banded_offsets(nbr_idx, row_ptr):
    """Detect a banded neighbor structure and return its diagonal offsets.

    For sorted 1-D inputs a radius query returns contiguous neighbor ranges
    ``[lo_i, hi_i]`` around each row; the sparse matrix is then a
    variable-width band. Returns ``(offsets, lo, hi)`` — the offset array
    ``d_min..d_max`` and the per-row neighbor bounds — if every row is
    contiguous, else ``None``.
    """
    n = len(row_ptr) - 1
    if n == 0 or len(nbr_idx) == 0:
        return None
    counts = np.diff(row_ptr)
    starts = row_ptr[:-1]
    if not np.all(counts > 0):
        # empty rows cannot occur with a self-including radius query; in
        # a user CSR they would poke holes in the boundary bookkeeping
        return None
    # rows must be strictly increasing: max-min+1 == count alone is fooled
    # by duplicate indices in a user CSR (e.g. [1, 1, 3])
    d = np.diff(nbr_idx)
    row_boundary = np.zeros(len(d), dtype=bool)
    inner = row_ptr[1:-1]
    row_boundary[inner[(inner > 0) & (inner <= len(d))] - 1] = True
    if not np.all(d[~row_boundary] > 0):
        return None
    lo = np.minimum.reduceat(nbr_idx, starts)
    hi = np.maximum.reduceat(nbr_idx, starts)
    if not np.array_equal(hi - lo + 1, counts):
        return None
    rows = np.arange(n)
    d_min = int(np.min(lo - rows))
    d_max = int(np.max(hi - rows))
    if d_max - d_min + 1 > 4 * max(int(counts.max()), 1):
        # pathological spread: the padded band would waste memory
        return None
    return (np.arange(d_min, d_max + 1, dtype=np.int64),
            lo.astype(np.int64), hi.astype(np.int64))


def banded_ell_tables(offsets, lo, hi, n):
    """The ``(nbr, mask)`` ELL tables of a banded structure, so the same
    ``ell_values`` entry evaluation serves the DIA path. Out-of-band slots
    are masked, their index clipped into ``[0, n)``."""
    rows = np.arange(n, dtype=np.int64)[:, None]
    cols = rows + offsets[None, :]
    mask = (cols >= lo[:, None]) & (cols <= hi[:, None])
    mask &= (cols >= 0) & (cols < n)
    nbr = np.clip(cols, 0, n - 1).astype(np.int32)
    return nbr, mask


def dia_apply(vals, offsets, diag, y):
    """``(K + diag) y`` for a banded structure: the DIA kernel
    (``ops/dia.py``) on CUDA tensors, its plain shifted-slice version on
    CPU tensors."""
    return dia_matvec(vals, offsets, diag, y)


def _colnorm(V, rowsum):
    """Column norms of ``V`` ``(n, k)``; ``rowsum`` completes the sums of
    a row-sharded ``V`` over the ranks (``None``: ``V`` holds every row)."""
    if rowsum is None:
        return torch.linalg.vector_norm(V, dim=0)
    return torch.sqrt(rowsum(torch.sum(V * V, dim=0)))


def _lanczos(matvec, V0, num_steps, keep_basis=False, rowsum=None):
    """Lanczos on the columns of ``V0`` ``(n, k)`` at once (each column its
    own Krylov space; one multi-RHS ``matvec`` per step). The columns must
    have unit norm. Returns the tridiagonals ``(k, m, m)`` and, with
    ``keep_basis``, the basis ``(m, n, k)``. ``rowsum`` completes the
    column sums of row-sharded vectors (see :func:`pcg_solve`)."""
    red = rowsum or (lambda t: t)
    v_prev = torch.zeros_like(V0)
    v = V0
    beta_prev = V0.new_zeros(V0.shape[1])
    alphas, betas, basis = [], [], []
    for _ in range(num_steps):
        w = matvec(v) - beta_prev * v_prev
        alpha = red(torch.sum(w * v, dim=0))
        w = w - alpha * v
        # one round of reorthogonalization against v_prev
        w = w - red(torch.sum(w * v_prev, dim=0)) * v_prev
        beta = _colnorm(w, rowsum)
        if keep_basis:
            basis.append(v)
        alphas.append(alpha)
        betas.append(beta)
        v_prev, v = v, w / torch.where(beta > 0, beta, 1.0)
        beta_prev = beta
    a = torch.stack(alphas, dim=1)                  # (k, m)
    b = torch.stack(betas, dim=1)[:, :-1]           # (k, m - 1)
    T = torch.diag_embed(a) + torch.diag_embed(b, 1) + torch.diag_embed(b, -1)
    return T, (torch.stack(basis) if keep_basis else None)


def lanczos_fn_matvec(matvec, b, fn, num_steps=40, rowsum=None):
    """``f(A) b`` for SPD ``A`` by the Lanczos method: ``b`` spans a Krylov
    space ``V_m``, ``A`` restricted to it is the tridiagonal ``T_m``, and
    ``f(A) b ~= ||b|| V_m f(T_m) e1``. ``b``: ``(n,)``, or ``(n, k)`` for
    ``k`` independent vectors transported in one block."""
    squeeze = b.ndim == 1
    B = b[:, None] if squeeze else b
    beta0 = _colnorm(B, rowsum)                              # (k,)
    V0 = B / torch.where(beta0 > 0, beta0, 1.0)
    T, V = _lanczos(matvec, V0, num_steps, keep_basis=True, rowsum=rowsum)
    evals, evecs = torch.linalg.eigh(T)                      # (k, m), (k, m, m)
    coeff = torch.einsum(
        "kij,kj->ki", evecs, fn(torch.clamp_min(evals, 0.0)) * evecs[:, 0, :])
    out = beta0 * torch.einsum("mnk,km->nk", V, coeff)
    return out[:, 0] if squeeze else out


def slq_logdet(matvec, probes, num_steps=30, return_std=False, rowsum=None,
               n=None):
    """Stochastic Lanczos quadrature estimate of ``log det A`` for SPD A.

    ``probes`` is the ``(num_probes, n)`` probe matrix (Rademacher, in the
    JAX package's layout); all probes run as one ``(n, num_probes)`` block,
    ``num_steps`` Lanczos steps, Gauss quadrature from the tridiagonals'
    eigendecompositions. With ``return_std=True`` also returns the
    Monte-Carlo standard error (std of the per-probe values /
    sqrt(num_probes)). Row-sharded probes pass ``rowsum`` (see
    :func:`pcg_solve`) and the whole operator's size ``n``.
    """
    P = probes.mT
    n = P.shape[0] if n is None else int(n)
    num_probes = P.shape[1]
    V0 = P / _colnorm(P, rowsum)
    T, _ = _lanczos(matvec, V0, num_steps, rowsum=rowsum)
    evals, evecs = torch.linalg.eigh(T)
    evals = torch.clamp_min(evals, torch.finfo(evals.dtype).tiny)
    estimates = torch.sum(evecs[:, 0, :] ** 2 * torch.log(evals), dim=1)
    mean = n * torch.mean(estimates)
    if return_std:
        stderr = n * torch.std(estimates, correction=0) / float(
            np.sqrt(num_probes))
        return mean, stderr
    return mean


def pcg_solve(matvec, precond, b, tol=1e-10, maxiter=200, rowsum=None):
    """Preconditioned CG for SPD ``A x = b`` with an SPD preconditioner
    apply ``precond(r) ~= A^{-1} r`` (vector or multi-RHS, every column
    iterated until all meet ``||r|| <= tol ||b||``). Returns ``(x,
    iterations)``; the stopping test reads one scalar back to the host per
    iteration (counted in ``diagnostics.host_reads``; the iterations in
    ``cg_iteration_count``). With the rows split over ranks, ``rowsum``
    completes each column sum over them, so every rank stops at the same
    iteration. :func:`cg_solve` takes this loop only for such rows."""
    global cg_iteration_count
    red = rowsum or (lambda t: t)
    squeeze = b.ndim == 1
    B = b[:, None] if squeeze else b
    X = torch.zeros_like(B)
    R = B                           # B - A X at X = 0
    Z = precond(R)
    P = Z
    rz = red(torch.sum(R * Z, dim=0))
    b2 = torch.clamp_min(red(torch.sum(B * B, dim=0)),
                         torch.finfo(B.dtype).tiny)
    tol2 = tol * tol
    it = 0
    while it < maxiter and _host_any(red(torch.sum(R * R, dim=0)) / b2
                                     > tol2):
        AP = matvec(P)
        denom = red(torch.sum(P * AP, dim=0))
        alpha = rz / torch.where(denom > 0, denom, 1.0)
        X = X + alpha * P
        R = R - alpha * AP
        Z = precond(R)
        rz_new = red(torch.sum(R * Z, dim=0))
        P = Z + (rz_new / torch.where(rz > 0, rz, 1.0)) * P
        rz = rz_new
        it += 1
        cg_iteration_count += 1
    return (X[:, 0] if squeeze else X), it


def _host_any(t):
    """``bool(torch.any(t))``, one device-to-host read."""
    count_host_read()
    return bool(torch.any(t))


def cg_solve(matvec, b, precond_diag, tol=1e-10, maxiter=1000, rowsum=None):
    """Jacobi-preconditioned CG for SPD ``A x = b`` (preconditioner ``r /
    precond_diag``): :func:`pcg_solve`'s iteration and answer, its
    iteration count in ``cg_iteration_count`` too, with the stopping test
    kept on the device. Each step is ``matvec`` then one ``ops/cg.py``
    step (the CUDA kernel on CUDA tensors, its plain version on CPU
    tensors), which also sets the device's ``done`` flag and counts the
    iterations; the host reads the pair every :data:`CG_READ_EVERY` steps
    (``diagnostics.host_reads``: ``ceil(iterations / CG_READ_EVERY) + 1``
    a solve), and the steps enqueued past the stop change nothing. Rows
    split over ranks (``rowsum`` given, see :func:`pcg_solve`) take
    :func:`pcg_solve`'s loop: there a column sum needs a collective between
    its partial and its use."""
    global cg_iteration_count
    if rowsum is not None:
        Minv = (1.0 / precond_diag)[:, None]
        return pcg_solve(matvec, lambda R: Minv * R, b, tol=tol,
                         maxiter=maxiter, rowsum=rowsum)
    squeeze = b.ndim == 1
    B = b[:, None] if squeeze else b
    minv = 1.0 / precond_diag
    X = torch.zeros_like(B)
    R = B.clone()                   # B - A X at X = 0; the kernel writes it
    P = minv[:, None] * R
    rz = torch.sum(R * P, dim=0)
    b2 = torch.clamp_min(torch.sum(B * B, dim=0), torch.finfo(B.dtype).tiny)
    tol2 = tol * tol
    state = torch.zeros(2, dtype=torch.int32, device=B.device)   # done, it
    state[0] = ~torch.any(torch.sum(R * R, dim=0) / b2 > tol2) | (maxiter <= 0)
    work = (cg_workspace(X, R, P, minv, rz, b2, state) if X.is_cuda
            else None)
    steps = 0
    while True:
        if steps % CG_READ_EVERY == 0:
            count_host_read()
            done, it = state.tolist()
            if done:
                break
        X, R, P, rz, state = cg_step(X, R, P, matvec(P).contiguous(), minv,
                                     rz, b2, state, tol2, maxiter, work)
        steps += 1
    cg_iteration_count += it
    return (X[:, 0] if squeeze else X), it


def cg_diff_solve(matvec, b, precond_diag, tol=1e-10, maxiter=1000):
    """Differentiable SPD solve ``A^{-1} b``: :func:`cg_solve`, with the
    derivatives of JAX's ``custom_linear_solve`` (``symmetric=True``) in
    ``b`` and in every tensor ``matvec`` closes over, by implicit
    differentiation: one more CG solve for a cotangent or a tangent, no
    unrolled iterations. The value is the CG solution ``x``; the
    derivatives come from ``x + S(b - A x)``, where ``S`` is ``A^{-1}`` in
    its derivatives and zero in its value (the residual is below the CG
    tolerance), so they are ``A^{-1} (db - dA x)``."""
    def solve(rhs):
        with torch.no_grad():
            return cg_solve(matvec, rhs, precond_diag, tol=tol,
                            maxiter=maxiter)[0]

    x = solve(b)
    return x + _ResidualSolve.apply(b - matvec(x), solve)


class _ResidualSolve(torch.autograd.Function):
    """``S(r) = 0`` with the derivatives of ``A^{-1} r``, ``A`` symmetric:
    the backward and the forward-mode rule apply ``solve`` (``A^{-1}``) to
    the cotangent or the tangent. Arguments: ``(r, solve)``."""

    @staticmethod
    def forward(r, solve):
        return torch.zeros_like(r)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.solve = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return ctx.solve(g), None

    @staticmethod
    def jvp(ctx, r_t, _):
        return ctx.solve(r_t)


def _per_member(apply, info, in_dims, args):
    """A Function's ``vmap`` rule that runs the batch members one after
    another: ``apply`` on each member's slice of the batched arguments,
    the results (a tensor, or each tensor of a tuple) stacked along
    dimension 0."""
    outs = [apply(*[a if d is None else a.select(d, i)
                    for a, d in zip(args, in_dims)])
            for i in range(info.batch_size)]
    if isinstance(outs[0], tuple):
        return (tuple(torch.stack(o) for o in zip(*outs)),
                (0,) * len(outs[0]))
    return torch.stack(outs), 0


class _Iteration(object):
    """What :class:`_CgSolve` and :class:`_SlqLogdet` use besides their
    tensors: ``apply(vals, Y, diag) = (K + diag) Y`` on the rows they hold,
    CG's tolerance and iteration cap, SLQ's Lanczos steps, the operator's
    size ``n``, and from the ``RowShard`` of a row-sharded layout
    (``None``: the rows are all here) ``rowsum``, completing a column sum
    over the ranks, and ``whole``, every rank's rows of a vector in the
    order the neighbour ids index."""

    def __init__(self, apply, tol, maxiter, num_steps, n, shard=None):
        self.apply, self.tol, self.maxiter = apply, tol, maxiter
        self.num_steps, self.n = num_steps, n
        self.rowsum = None if shard is None else shard.sum
        self.whole = (lambda t: t) if shard is None else shard.gather


class _CgSolve(torch.autograd.Function):
    """``z = (K + diag)^{-1} b`` by Jacobi-preconditioned CG through the
    solver's fixed-table apply, differentiable in the value table, the
    diagonal and ``b`` by implicit differentiation (the port of
    ``cg_diff_solve``, JAX's ``custom_linear_solve``): the backward is one
    more CG solve ``w = K^{-1} z_bar``, then ``b_bar = w``,
    ``vals_bar[i, j] = -w_i z[nbr[i, j]]`` on the masked slots and
    ``diag_bar = -w * z``. On a row-sharded layout every tensor holds this
    rank's rows, and ``z[nbr]`` reads the gathered ``z`` (the neighbour
    ids are global).

    Arguments: ``(vals, diag, b, pdiag, nbr, mask, it)``, with ``it`` an
    :class:`_Iteration` and ``pdiag`` the preconditioner (not
    differentiated: the solution does not depend on it). Under
    ``torch.func.vmap`` the batch members run one after another: CG's
    stopping test reads the host and the DIA kernel takes plain tensors,
    so chains are not batched into one launch here."""

    @staticmethod
    def forward(vals, diag, b, pdiag, nbr, mask, it):
        vals, diag = vals.contiguous(), diag.contiguous()
        with annotate("sparse.cg"):
            z, _ = cg_solve(lambda Y: it.apply(vals, Y, diag), b.contiguous(),
                            pdiag, tol=it.tol, maxiter=it.maxiter,
                            rowsum=it.rowsum)
        return z

    @staticmethod
    def setup_context(ctx, inputs, output):
        vals, diag, _, pdiag, nbr, mask, it = inputs
        ctx.save_for_backward(vals, diag, pdiag, nbr, mask, output)
        ctx.it = it

    @staticmethod
    def vmap(info, in_dims, *args):
        return _per_member(_CgSolve.apply, info, in_dims, args)

    @staticmethod
    def backward(ctx, z_bar):
        vals, diag, pdiag, nbr, mask, z = ctx.saved_tensors
        with annotate("sparse.adjoint"):
            w = _CgSolve.apply(vals, diag, z_bar, pdiag, nbr, mask, ctx.it)
            vals_bar = -w[:, None] * ctx.it.whole(z)[nbr] * mask
            return vals_bar, -w * z, w, None, None, None, None


class _SlqLogdet(torch.autograd.Function):
    """``log det(K + diag)`` by stochastic Lanczos quadrature over the
    probe block ``V`` ``(n, num_probes)``, with the Hutchinson adjoint of
    the JAX package's ``slq_ld``: a CG solve ``K^{-1} V`` of the SAME probe
    block (common random numbers between value and gradient), then
    ``diag_bar = g * mean_k(V * K^{-1} V)`` and ``vals_bar[i, j] = g *
    mean_k V[i, k] (K^{-1} V)[nbr[i, j], k]`` on the masked slots,
    accumulated probe by probe so that about two value tables are live.
    On a row-sharded layout ``V`` holds this rank's rows, the Lanczos sums
    are reduced over the ranks and ``(K^{-1} V)[nbr]`` reads the gathered
    block.

    Arguments: ``(vals, diag, V, pdiag, nbr, mask, it)`` (see
    :class:`_CgSolve`). Under ``torch.func.vmap`` the batch members run
    one after another (the backward's CG reads the host)."""

    @staticmethod
    def forward(vals, diag, V, pdiag, nbr, mask, it):
        vals, diag = vals.contiguous(), diag.contiguous()
        with annotate("sparse.slq"):
            return slq_logdet(lambda Y: it.apply(vals, Y, diag), V.mT,
                              num_steps=it.num_steps, rowsum=it.rowsum,
                              n=it.n)

    @staticmethod
    def setup_context(ctx, inputs, output):
        vals, diag, V, pdiag, nbr, mask, it = inputs
        ctx.save_for_backward(vals, diag, V, pdiag, nbr, mask)
        ctx.it = it

    @staticmethod
    def vmap(info, in_dims, *args):
        return _per_member(_SlqLogdet.apply, info, in_dims, args)

    @staticmethod
    def backward(ctx, g):
        vals, diag, V, pdiag, nbr, mask = ctx.saved_tensors
        with annotate("sparse.adjoint"):
            KinvV = _CgSolve.apply(vals, diag, V, pdiag, nbr, mask, ctx.it)
            num_probes = V.shape[1]
            diag_bar = g * torch.mean(V * KinvV, dim=1)
            KinvV = ctx.it.whole(KinvV)
            acc = torch.zeros_like(vals)
            for k in range(num_probes):
                acc = acc + V[:, k, None] * KinvV[:, k][nbr]
            vals_bar = g * (acc / num_probes) * mask
            return (vals_bar, diag_bar) + (None,) * 5


class SparseSolver(object):
    """Compact-support sparse solver with the george solver protocol.

    Requires a kernel with a finite :func:`get_cutoff` (e.g.
    :class:`WendlandC2Kernel`) or an explicit ``radius``.

    :param kernel: covariance kernel.
    :param radius: sparsity radius override (default: kernel cutoff).
    :param cg_tol: relative CG tolerance (floored at ``30 * eps`` of the
        working dtype).
    :param maxiter: CG iteration cap.
    :param num_probes: SLQ probe count for logdet / Hutchinson gradients.
    :param num_steps: SLQ Lanczos steps.
    :param seed: probe seed: the SLQ probes come from a ``torch.Generator``
        seeded with ``seed``, the Hutchinson probes with ``seed + 1``.
    :param probes: explicit SLQ probe matrix ``(num_probes, n)`` (numpy),
        e.g. to share probes with another implementation.
    :param grad_probes: explicit Hutchinson probe matrix ``(num_probes, n)``.
    :param direct: ``"auto"`` (default) factors banded structures (sorted
        1-D compact support) exactly by a block-tridiagonal Cholesky
        (``solvers/banded.py``); ``False`` always uses CG + SLQ; ``True``
        requires the direct path and raises if infeasible.
    :param device: torch device (default ``"cuda"``; pass ``"cpu"``
        explicitly on a host without a card).
    :param dtype: working dtype (default ``torch.float64``).
    :param mesh: a one-dimensional ``torch.distributed`` ``DeviceMesh``
        (``parallel.chain_mesh()``) to split the rows over; every rank
        runs the same calls with the same data and gets whole results.
        The iterative path only (``direct=True`` raises); the likelihood,
        its gradient, solves, matvecs, ``apply_sqrt`` and ``loglike_fn``
        (``GP.log_prob_fn``, under the samplers' ``vmap`` too) run
        sharded.

    ``cg_iterations`` holds the iterations of the last ``dot_solve`` or
    ``apply_inverse`` solve (0 on the direct path); the module's
    ``cg_iteration_count`` counts those of every path, ``loglike_fn``'s
    too.
    """

    matrix_free = True

    def __init__(self, kernel, radius=None, cg_tol=1e-10, maxiter=1000,
                 num_probes=16, num_steps=30, seed=42, mesh=None,
                 direct="auto", probes=None,
                 grad_probes=None, device="cuda", dtype=torch.float64,
                 **kwargs):
        if mesh is not None and not hasattr(mesh, "get_group"):
            raise TypeError("mesh must be a torch.distributed DeviceMesh "
                            "(george_tpu_torch.parallel.chain_mesh)")
        self.mesh = mesh
        self._shard = None
        if direct not in ("auto", True, False):
            raise ValueError(
                "direct must be 'auto', True, or False, got %r" % (direct,)
            )
        self.kernel = kernel
        self.radius = radius
        self.direct = direct
        self.cg_tol = float(cg_tol)
        self.maxiter = int(maxiter)
        self.num_probes = int(num_probes)
        self.num_steps = int(num_steps)
        self.seed = int(seed)
        self.probes = probes
        self.grad_probes = grad_probes
        self.device = torch.device(device)
        self.dtype = dtype
        self.computed = False
        self.log_determinant = None
        self.log_determinant_std = None
        self.cg_iterations = None

    def _tensor(self, a):
        return torch.tensor(np.ascontiguousarray(a, dtype=np.float64),
                            device=self.device, dtype=self.dtype)

    def _probe_block(self, given, seed):
        """``(n, num_probes)`` Rademacher probes: ``given`` (numpy
        ``(num_probes, n)``) or drawn from a generator seeded with
        ``seed``."""
        n = self._n
        if given is not None:
            given = np.asarray(given, dtype=np.float64)
            if given.shape != (self.num_probes, n):
                raise ValueError("probes must have shape (%d, %d), got %s"
                                 % (self.num_probes, n, given.shape))
            return self._tensor(given.T).contiguous()
        gen = torch.Generator(device=self.device).manual_seed(seed)
        bits = torch.randint(0, 2, (self.num_probes, n), generator=gen,
                             device=self.device)
        return (2 * bits - 1).to(self.dtype).mT.contiguous()

    # -- row sharding ------------------------------------------------------

    def _rowsum(self, x):
        """Column sums over the rows, completed over the mesh's ranks."""
        return x if self._shard is None else self._shard.sum(x)

    def _local(self, Y, fill=0.0):
        """This rank's rows of ``Y`` (``(n, ...)``, every row): rows of
        ``fill`` pad it to the mesh's multiple first."""
        if self._shard is None:
            return Y
        if self._pad_rows:
            Y = torch.cat([Y, Y.new_full((self._pad_rows,) + Y.shape[1:],
                                         fill)])
        a, b = self._shard.block(Y.shape[0])
        return Y[a:b]

    def _whole(self, Y):
        """Every row of ``Y`` from each rank's block, padding dropped."""
        if self._shard is None:
            return Y
        Y = self._shard.gather(Y)
        return Y[:Y.shape[0] - self._pad_rows]

    # -- setup -------------------------------------------------------------

    def compute(self, x, yerr=0.0, nns=None, **kwargs):
        x = as_points(x)
        n = len(x)
        yerr2 = np.atleast_1d(np.asarray(yerr, dtype=np.float64)) ** 2
        if yerr2.size == 1:
            yerr2 = yerr2 * np.ones(n)

        radius = self.radius
        if radius is None:
            radius = self.kernel.get_cutoff()
        self._shard = row_shard(self.mesh)
        if self.mesh is not None and self.direct is True:
            raise ValueError(
                "direct=True, but the direct factorization is "
                "single-device only; drop mesh= or use direct=False")
        nns = normalize_nns(nns)
        if isinstance(nns, tuple):
            nbr_idx, row_ptr = (np.asarray(a, dtype=np.int64) for a in nns)
        elif nns is not None and np.ndim(nns) == 2:
            # rectangular kNN matrix: the symmetrized union pattern with
            # self-pairs (CG and SLQ need a symmetric operator)
            nbr_idx, row_ptr = knn_matrix_to_csr(nns, n)
        else:
            nbr_idx, row_ptr = radius_neighbors_csr(x, float(radius))
        self.nnz = int(row_ptr[-1])
        # under a mesh the band is not taken: the ELL gather is what the
        # rows split over (as in the JAX package)
        band = banded_offsets(nbr_idx, row_ptr) if self._shard is None \
            else None
        self._dia_offsets = None
        self._dia = None
        if band is not None:
            offsets, lo_rows, hi_rows = band
            nbr_np, mask_np = banded_ell_tables(offsets, lo_rows, hi_rows, n)
            self._dia_offsets = offsets
            # the band is known once: every later apply goes through this
            # operator, which keeps (d_min, D) and the kernel's launch plans
            self._dia = DiaOperator(offsets, n)
        else:
            nbr_np, mask_np = ell_from_csr(nbr_idx, row_ptr)
        self._n = n
        self._pad_rows = 0
        if self._shard is not None:
            # padded rows: no neighbours, a unit diagonal
            pad = (-n) % self._shard.world
            self._pad_rows = pad
            nbr_np = np.concatenate(
                [nbr_np, np.zeros((pad, nbr_np.shape[1]), nbr_np.dtype)])
            mask_np = np.concatenate(
                [mask_np, np.zeros((pad, mask_np.shape[1]), bool)])
            x = np.concatenate([x, np.repeat(x[-1:], pad, axis=0)])
            yerr2 = np.concatenate([yerr2, np.ones(pad)])
            a, b = self._shard.block(n + pad)
            nbr_np, mask_np = nbr_np[a:b], mask_np[a:b]
            yerr2 = yerr2[a:b]
        self._x = self._tensor(x)
        # the points of this rank's rows
        self._xrows = self._x if self._shard is None else self._x[a:b]
        self._nbr = torch.as_tensor(nbr_np.astype(np.int64),
                                    device=self.device)
        self._mask = torch.as_tensor(mask_np, device=self.device)
        self._diag = self._tensor(yerr2)
        self._theta = self._tensor(self.kernel.parameter_vector)
        pair = self.kernel.pair_fn
        with torch.no_grad():
            # the entry table at the compute-time theta, shared by every
            # fixed-theta application (CG, SLQ, Lanczos, solves)
            self._vals = self._values(self._theta)
            kdiag = torch.broadcast_to(
                pair(self._theta, self._xrows, self._xrows),
                self._diag.shape)
            self._pdiag = kdiag + self._diag   # Jacobi preconditioner
        # float32 cannot reach 1e-10 residuals: floor the tolerance at the
        # dtype's achievable accuracy
        self._eff_tol = max(self.cg_tol,
                            30.0 * float(torch.finfo(self.dtype).eps))

        offsets = self._dia_offsets
        bsz = None
        if offsets is not None and self.direct in ("auto", True):
            bsz = band_block_size(
                n, offsets, itemsize=torch.finfo(self.dtype).bits // 8)
        if self.direct is True and bsz is None:
            reason = (
                "the structure is not banded — it needs sorted 1-D "
                "compact-support data" if offsets is None
                else "the band is infeasibly wide for this n"
            )
            raise ValueError("direct=True, but " + reason)

        self._direct_loglike = None
        self._band_factors = None
        if bsz is not None:
            self._block_size = bsz
            self._direct_loglike = banded_loglike_fn(self._values, offsets,
                                                     bsz, n)
            # factor once at the compute-time theta; solves and sampling
            # reuse the factors
            with torch.no_grad():
                Ls, Cs, ld = banded_cholesky(
                    *band_blocks(self._vals, offsets, self._diag, bsz))
            if not bool(torch.isfinite(ld)):
                raise np.linalg.LinAlgError(
                    "banded Cholesky log-determinant is not finite"
                )
            self._band_factors = (Ls, Cs)
        else:
            with torch.no_grad():
                ld, std = slq_logdet(
                    self._apply_fixed,
                    self._local(self._probe_block(self.probes,
                                                  self.seed)).mT,
                    num_steps=self.num_steps, return_std=True,
                    rowsum=None if self._shard is None else self._rowsum,
                    n=n,
                )
            if not bool(torch.isfinite(ld)):
                raise np.linalg.LinAlgError("SLQ log-determinant diverged")
            self.log_determinant_std = float(std)
        self.log_determinant = float(ld)
        self.computed = True

    def _values(self, theta):
        return ell_values(self.kernel.pair_fn, theta, self._x, self._nbr,
                          self._mask, rows=self._xrows)

    def _apply(self, vals, Y, diag):
        """``(K + diag) Y`` on this rank's rows (all of them unsharded):
        the DIA kernel on a band, else the ELL gather, which under a mesh
        gathers ``Y`` from every rank first."""
        if self._dia is not None:
            # the kernel takes row-major blocks; a transposed right-hand
            # side and CG's updates of it are not
            return self._dia(vals, diag, Y.contiguous())
        if self._shard is None:
            return ell_apply(vals, self._nbr, diag, Y)
        squeeze = Y.ndim == 1
        Yl = Y[:, None] if squeeze else Y
        out = (torch.einsum("ik,ikr->ir", vals, self._shard.gather(Yl)[
            self._nbr]) + diag[:, None] * Yl)
        return out[:, 0] if squeeze else out

    def _apply_fixed(self, Y):
        """``(K + diag) Y`` at the compute-time theta."""
        return self._apply(self._vals, Y, self._diag)

    def _tangent_values(self, k):
        """``d vals / d theta_k`` (forward mode through ``ell_values``)."""
        e = torch.zeros_like(self._theta)
        e[k] = 1.0
        return torch.func.jvp(self._values, (self._theta,), (e,))[1]

    def _solve(self, B):
        """``(K + diag)^{-1} B`` on device: the banded factors on the
        direct path, else CG (its iteration count kept in
        ``cg_iterations``)."""
        with torch.no_grad():
            if self._band_factors is not None:
                self.cg_iterations = 0
                return banded_solve(*self._band_factors, B)
            X, self.cg_iterations = cg_solve(
                self._apply_fixed, self._local(B), self._pdiag,
                tol=self._eff_tol, maxiter=self.maxiter,
                rowsum=None if self._shard is None else self._rowsum)
            return self._whole(X)

    def loglike_fn(self):
        """Pure ``f(theta_kernel, diag, r) -> log-likelihood`` (the
        contract of the hierarchical solver's), differentiable by autograd
        and ``torch.func`` in ``theta``, ``diag`` and ``r``.

        On the banded direct path: the fused exact block-Cholesky
        likelihood. Otherwise: the entry table ``ell_values(theta)`` by
        autograd, the quadratic term by a CG solve with an implicit adjoint
        (:class:`_CgSolve`) and the log-determinant by SLQ over the
        solver's SLQ probe block with a Hutchinson adjoint over the same
        probes (:class:`_SlqLogdet`), both applying ``K + diag`` through
        the solver's apply (the DIA kernel on a band). The probe set is
        fixed per solver, so likelihood differences across theta — what
        optimizers and samplers consume — largely cancel its noise. The CG
        preconditioner is the self-slot entry of the table at ``theta`` plus
        ``diag`` (the masked-valid self slot: boundary rows of a band also
        carry clipped, masked slots that point at the row). Under ``mesh=``
        every rank evaluates its rows of the table and of the adjoints, and
        the value and its gradient are whole on every rank."""
        if self._direct_loglike is not None:
            return self._direct_loglike
        n, shard = self._n, self._shard
        rows = torch.arange(self._nbr.shape[0], device=self.device)[:, None]
        if shard is not None:
            rows = rows + shard.block(n + self._pad_rows)[0]
        self_slot = torch.argmax(((self._nbr == rows) & self._mask).to(
            torch.int8), dim=1)[:, None]
        probes = self._local(self._probe_block(self.probes, self.seed))
        nbr, mask = self._nbr, self._mask
        it = _Iteration(self._apply, self._eff_tol, self.maxiter,
                        self.num_steps, n, shard)
        log_2pi = float(np.log(2.0 * np.pi))

        def enter(t):
            """A replicated input as it enters this rank's rows."""
            return t if shard is None else replicated(t, shard.group)

        def loglike(theta_k, diag, r):
            vals = self._values(enter(theta_k))
            diag = self._local(enter(diag), fill=1.0)
            r = self._local(enter(r))
            pdiag = (vals.gather(1, self_slot)[:, 0] + diag).detach()
            z = _CgSolve.apply(vals, diag, r, pdiag, nbr, mask, it)
            ld = _SlqLogdet.apply(vals, diag, probes, pdiag, nbr, mask, it)
            return -0.5 * (self._rowsum(torch.dot(r, z)) + ld + n * log_2pi)

        return loglike

    # -- protocol ----------------------------------------------------------

    @staticmethod
    def _numpy(t):
        return t.detach().cpu().numpy().astype(np.float64)

    def apply_inverse(self, y, in_place=False):
        return self._numpy(self._solve(self._tensor(y)))

    def solve_columns(self, R):
        """``(K + diag)^{-1} R`` for columns ``R (n, k)`` by :meth:`_solve`
        (the banded factors or CG; whole rows on every rank under
        ``mesh=``), on the solver's device in its dtype, staying there."""
        return self._solve(R)

    def dot_solve(self, y):
        y = self._tensor(y)
        return float(torch.dot(y, self._solve(y)))

    def apply_forward(self, y, i=0):
        """``(K + diag) y`` (``i == 0``) or ``(dK/dtheta_{i-1}) y``, through
        the same apply as the solves (the DIA kernel on a band)."""
        Y = self._local(self._tensor(y))
        with torch.no_grad():
            if i == 0:
                return self._numpy(self._whole(self._apply_fixed(Y)))
        dvals = self._tangent_values(i - 1)
        with torch.no_grad():
            return self._numpy(self._whole(self._apply(
                dvals, Y, torch.zeros_like(self._diag))))

    def get_inverse(self):
        return self.apply_inverse(np.eye(self._n))

    def apply_sqrt(self, r, num_steps=None):
        """Rows of ``r`` transported by a square root of ``K + diag`` (the
        ``R = apply_sqrt(I)``, ``R^T R = K + diag`` contract of the dense
        solver).

        On the banded direct path this is the exact triangular factor ``W``
        (``K + diag = W W^T``; ``num_steps`` is ignored). Otherwise it is
        the symmetric square root by Lanczos ``f(A) b`` over all rows as
        one block, ``num_steps`` steps (default: the solver's
        ``num_steps``, floored at 30)."""
        m = int(num_steps) if num_steps is not None else max(
            self.num_steps, 30)
        r = np.asarray(r, dtype=np.float64)
        squeeze = r.ndim == 1
        R = self._tensor(r[None, :] if squeeze else r).mT   # (n, size)
        with torch.no_grad():
            if self._band_factors is not None:
                cols = banded_sqrt_matvec(*self._band_factors, R)
            else:
                cols = self._whole(lanczos_fn_matvec(
                    self._apply_fixed, self._local(R).contiguous(),
                    torch.sqrt, num_steps=m,
                    rowsum=None if self._shard is None else self._rowsum))
        out = self._numpy(cols).T
        return out[0] if squeeze else out

    # -- gradients ---------------------------------------------------------

    def grad_log_likelihood(self, gp, x, alpha, unfrozen_mask):
        """Gradient of the GP marginal likelihood over the active GP
        parameter vector (mean, white-noise, kernel blocks).

        On the banded direct path it is exact: one autograd sweep of the
        fused block-Cholesky likelihood in theta and the diagonal.
        Otherwise the kernel block is the Hutchinson estimate
        ``1/2 a^T dK_k a - 1/2 mean_u[(K^{-1} u)^T dK_k u]``: one
        multi-RHS CG for the probes, then for each theta direction the
        tangent value table applied to ``[a | probes]`` in one launch.
        """
        alpha = np.asarray(alpha, dtype=np.float64)
        a = self._tensor(alpha)
        if self._direct_loglike is not None:
            with torch.no_grad():
                r = self._apply_fixed(a)                 # (K + diag) alpha
            theta = self._theta.clone().requires_grad_(True)
            diag = self._diag.clone().requires_grad_(True)
            ll = self._direct_loglike(theta, diag, r)
            g_theta, g_diag = torch.autograd.grad(ll, (theta, diag))
            g_kernel = self._numpy(g_theta)
            # d ll / d diag_i = 1/2 (a_i^2 - K^{-1}_ii)
            half_diag_A = self._numpy(g_diag)
        else:
            probes = self._probe_block(self.grad_probes, self.seed + 1)
            Kinv_u = self._solve(probes)
            # this rank's rows (all of them unsharded)
            av = self._local(torch.cat([a[:, None], probes], dim=1))
            Kinv_u_l = self._local(Kinv_u)
            zero = torch.zeros_like(self._diag)
            g_kernel = np.zeros(self._theta.shape[0])
            for k in range(len(g_kernel)):
                dvals = self._tangent_values(k)
                with torch.no_grad():
                    dK_av = self._apply(dvals, av, zero)
                    quad = self._rowsum(torch.dot(av[:, 0], dK_av[:, 0]))
                    trace = torch.mean(self._rowsum(torch.sum(
                        Kinv_u_l * dK_av[:, 1:], dim=0)))
                g_kernel[k] = 0.5 * float(quad) - 0.5 * float(trace)
                del dvals, dK_av
            # diag(K^{-1}) by Hutchinson with the same probes
            with torch.no_grad():
                diag_Kinv = self._numpy(torch.mean(probes * Kinv_u, dim=1))
            half_diag_A = 0.5 * (alpha ** 2 - diag_Kinv)

        mean_g = []
        if len(gp.mean):
            mean_g = list(np.dot(gp._call_mean_gradient(np.asarray(x)),
                                 alpha))
        wn_g = []
        if len(gp.white_noise):
            wn = gp._call_white_noise(np.asarray(x))
            wng = gp._call_white_noise_gradient(np.asarray(x))
            wn_g = list(np.sum((np.exp(wn) * half_diag_A)[None, :] * wng,
                               axis=1))
        kmask = gp.kernel.unfrozen_mask
        return np.array(mean_g + wn_g + list(g_kernel[kmask]))

    def __getstate__(self):
        state = self.__dict__.copy()
        for k in ("_x", "_xrows", "_nbr", "_mask", "_diag", "_theta",
                  "_vals", "_pdiag", "_direct_loglike", "_band_factors",
                  "_dia"):
            state.pop(k, None)
        state["computed"] = False
        state["mesh"] = None      # a process group does not serialize
        state["_shard"] = None
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
