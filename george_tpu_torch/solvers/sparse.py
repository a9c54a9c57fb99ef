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
* solves by Jacobi-preconditioned conjugate gradients (a Python loop);
* ``log_determinant`` by stochastic Lanczos quadrature (SLQ) over one
  ``(n, num_probes)`` block of Rademacher probes;
* gradients by ``d ll / d theta = 1/2 a^T (dK/dtheta) a
  - 1/2 tr(K^{-1} dK/dtheta)``, the trace Hutchinson-estimated with CG
  solves and the ``dK/dtheta`` products applied as tangent value tables
  (``torch.func.jvp`` of ``ell_values``) through the same apply.

On a band the default ``direct="auto"`` takes the exact block-tridiagonal
Cholesky of ``solvers/banded.py`` instead of CG and SLQ.

Not ported yet: ``mesh=`` (row sharding) and the iterative path's
``loglike_fn`` (the fused likelihood behind ``GP.log_prob_fn`` and the
samplers); both raise ``NotImplementedError``.
"""

import numpy as np
import torch

from ..neighbors import (
    knn_matrix_to_csr, normalize_nns, radius_neighbors_csr,
)
from ..ops.dia import dia_matvec
from .banded import (
    band_block_size, band_blocks, banded_cholesky, banded_loglike_fn,
    banded_solve, banded_sqrt_matvec,
)
from .linalg import as_points

__all__ = ["SparseSolver", "ell_from_csr", "ell_matvec", "ell_values",
           "ell_apply", "dia_apply", "banded_offsets", "banded_ell_tables",
           "cg_solve", "lanczos_fn_matvec", "slq_logdet"]


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


def ell_values(pair_fn, theta, x, nbr, mask):
    """Masked kernel-entry table ``vals[i, j] = k(x_i, x_nbr[i, j])``,
    shape ``(n, k_max)``; ``x`` ``(n, d)``, ``nbr`` an integer tensor and
    ``mask`` a bool tensor of the table's shape."""
    vals = pair_fn(theta, x[:, None, :], x[nbr])
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


def _lanczos(matvec, V0, num_steps, keep_basis=False):
    """Lanczos on the columns of ``V0`` ``(n, k)`` at once (each column its
    own Krylov space; one multi-RHS ``matvec`` per step). The columns must
    have unit norm. Returns the tridiagonals ``(k, m, m)`` and, with
    ``keep_basis``, the basis ``(m, n, k)``."""
    v_prev = torch.zeros_like(V0)
    v = V0
    beta_prev = V0.new_zeros(V0.shape[1])
    alphas, betas, basis = [], [], []
    for _ in range(num_steps):
        w = matvec(v) - beta_prev * v_prev
        alpha = torch.sum(w * v, dim=0)
        w = w - alpha * v
        # one round of reorthogonalization against v_prev
        w = w - torch.sum(w * v_prev, dim=0) * v_prev
        beta = torch.linalg.vector_norm(w, dim=0)
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


def lanczos_fn_matvec(matvec, b, fn, num_steps=40):
    """``f(A) b`` for SPD ``A`` by the Lanczos method: ``b`` spans a Krylov
    space ``V_m``, ``A`` restricted to it is the tridiagonal ``T_m``, and
    ``f(A) b ~= ||b|| V_m f(T_m) e1``. ``b``: ``(n,)``, or ``(n, k)`` for
    ``k`` independent vectors transported in one block."""
    squeeze = b.ndim == 1
    B = b[:, None] if squeeze else b
    beta0 = torch.linalg.vector_norm(B, dim=0)               # (k,)
    V0 = B / torch.where(beta0 > 0, beta0, 1.0)
    T, V = _lanczos(matvec, V0, num_steps, keep_basis=True)
    evals, evecs = torch.linalg.eigh(T)                      # (k, m), (k, m, m)
    coeff = torch.einsum(
        "kij,kj->ki", evecs, fn(torch.clamp_min(evals, 0.0)) * evecs[:, 0, :])
    out = beta0 * torch.einsum("mnk,km->nk", V, coeff)
    return out[:, 0] if squeeze else out


def slq_logdet(matvec, probes, num_steps=30, return_std=False):
    """Stochastic Lanczos quadrature estimate of ``log det A`` for SPD A.

    ``probes`` is the ``(num_probes, n)`` probe matrix (Rademacher, in the
    JAX package's layout); all probes run as one ``(n, num_probes)`` block,
    ``num_steps`` Lanczos steps, Gauss quadrature from the tridiagonals'
    eigendecompositions. With ``return_std=True`` also returns the
    Monte-Carlo standard error (std of the per-probe values /
    sqrt(num_probes)).
    """
    P = probes.mT
    n, num_probes = P.shape
    V0 = P / torch.linalg.vector_norm(P, dim=0)
    T, _ = _lanczos(matvec, V0, num_steps)
    evals, evecs = torch.linalg.eigh(T)
    evals = torch.clamp_min(evals, torch.finfo(evals.dtype).tiny)
    estimates = torch.sum(evecs[:, 0, :] ** 2 * torch.log(evals), dim=1)
    mean = n * torch.mean(estimates)
    if return_std:
        stderr = n * torch.std(estimates, correction=0) / float(
            np.sqrt(num_probes))
        return mean, stderr
    return mean


def cg_solve(matvec, b, precond_diag, tol=1e-10, maxiter=1000):
    """Jacobi-preconditioned CG for SPD ``A x = b`` (vector or multi-RHS,
    every column iterated until all meet ``||r|| <= tol ||b||``). Returns
    ``(x, iterations)``; the convergence test reads one scalar back to the
    host per iteration."""
    squeeze = b.ndim == 1
    B = b[:, None] if squeeze else b
    Minv = (1.0 / precond_diag)[:, None]
    X = torch.zeros_like(B)
    R = B.clone()                   # B - A X at X = 0
    Z = Minv * R
    P = Z
    rz = torch.sum(R * Z, dim=0)
    b2 = torch.clamp_min(torch.sum(B * B, dim=0), torch.finfo(B.dtype).tiny)
    tol2 = tol * tol
    it = 0
    while it < maxiter and bool(torch.any(torch.sum(R * R, dim=0) / b2
                                          > tol2)):
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


def _not_ported(what, where):
    return NotImplementedError(
        "SparseSolver %s is not ported to george_tpu_torch yet (ROADMAP.md "
        "Queue 1, %s)" % (what, where))


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
    """

    matrix_free = True

    def __init__(self, kernel, radius=None, cg_tol=1e-10, maxiter=1000,
                 num_probes=16, num_steps=30, seed=42, mesh=None,
                 direct="auto", probes=None,
                 grad_probes=None, device="cuda", dtype=torch.float64,
                 **kwargs):
        if mesh is not None:
            raise _not_ported("mesh= (row sharding)", "slice D, item 11")
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
        return torch.tensor(np.asarray(a, dtype=np.float64),
                            device=self.device, dtype=self.dtype)

    def _probe_block(self, given, seed):
        """``(n, num_probes)`` Rademacher probes: ``given`` (numpy
        ``(num_probes, n)``) or drawn from a generator seeded with
        ``seed``."""
        n = self._x.shape[0]
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
        band = banded_offsets(nbr_idx, row_ptr)
        self._dia_offsets = None
        if band is not None:
            offsets, lo_rows, hi_rows = band
            nbr_np, mask_np = banded_ell_tables(offsets, lo_rows, hi_rows, n)
            self._dia_offsets = offsets
        else:
            nbr_np, mask_np = ell_from_csr(nbr_idx, row_ptr)
        self._x = self._tensor(x)
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
            kdiag = torch.broadcast_to(pair(self._theta, self._x, self._x),
                                       (n,))
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
                    self._probe_block(self.probes, self.seed).mT,
                    num_steps=self.num_steps, return_std=True,
                )
            if not bool(torch.isfinite(ld)):
                raise np.linalg.LinAlgError("SLQ log-determinant diverged")
            self.log_determinant_std = float(std)
        self.log_determinant = float(ld)
        self.computed = True

    def _values(self, theta):
        return ell_values(self.kernel.pair_fn, theta, self._x, self._nbr,
                          self._mask)

    def _apply(self, vals, Y, diag):
        if self._dia_offsets is not None:
            return dia_apply(vals, self._dia_offsets, diag, Y)
        return ell_apply(vals, self._nbr, diag, Y)

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
                self._apply_fixed, B, self._pdiag, tol=self._eff_tol,
                maxiter=self.maxiter)
            return X

    def loglike_fn(self):
        """Pure ``f(theta_kernel, diag, r) -> log-likelihood``: on the
        banded direct path the fused exact block-Cholesky likelihood
        (differentiable by autograd). The iterative path's (CG + SLQ with
        custom adjoints) is not ported yet."""
        if self._direct_loglike is not None:
            return self._direct_loglike
        raise _not_ported("loglike_fn on the iterative path",
                          "slice B, item 7 (gp.log_prob_fn)")

    # -- protocol ----------------------------------------------------------

    @staticmethod
    def _numpy(t):
        return t.detach().cpu().numpy().astype(np.float64)

    def apply_inverse(self, y, in_place=False):
        return self._numpy(self._solve(self._tensor(y)))

    def dot_solve(self, y):
        y = self._tensor(y)
        return float(torch.dot(y, self._solve(y)))

    def apply_forward(self, y, i=0):
        """``(K + diag) y`` (``i == 0``) or ``(dK/dtheta_{i-1}) y``, through
        the same apply as the solves (the DIA kernel on a band)."""
        Y = self._tensor(y)
        with torch.no_grad():
            if i == 0:
                return self._numpy(self._apply_fixed(Y))
        dvals = self._tangent_values(i - 1)
        with torch.no_grad():
            return self._numpy(self._apply(dvals, Y,
                                           torch.zeros_like(self._diag)))

    def get_inverse(self):
        return self.apply_inverse(np.eye(self._x.shape[0]))

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
                cols = lanczos_fn_matvec(self._apply_fixed, R.contiguous(),
                                         torch.sqrt, num_steps=m)
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
            av = torch.cat([a[:, None], probes], dim=1)      # (n, 1 + P)
            zero = torch.zeros_like(self._diag)
            g_kernel = np.zeros(self._theta.shape[0])
            for k in range(len(g_kernel)):
                dvals = self._tangent_values(k)
                with torch.no_grad():
                    dK_av = self._apply(dvals, av, zero)
                    quad = torch.dot(a, dK_av[:, 0])
                    trace = torch.mean(torch.sum(Kinv_u * dK_av[:, 1:],
                                                 dim=0))
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
        for k in ("_x", "_nbr", "_mask", "_diag", "_theta", "_vals",
                  "_pdiag", "_direct_loglike", "_band_factors"):
            state.pop(k, None)
        state["computed"] = False
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
