# -*- coding: utf-8 -*-
"""Exact block-tridiagonal Cholesky for banded sparse systems (PyTorch port
of ``george_tpu/solvers/banded.py``).

Sorted 1-D compact-support data produces a banded covariance: every row's
neighbors are a contiguous index range (``sparse.banded_offsets``). A band
of half-width ``w`` is block-tridiagonal in blocks of size ``b >= w``, and
factors exactly by a sequential block Cholesky:

    ``L_0 = chol(A_0)``;  ``C_i = B_i L_{i-1}^{-T}``;
    ``L_i = chol(A_i - C_i C_i^T)``

— O(n b^2) work as a Python loop of dense ``(b, b)`` library calls
(``torch.linalg.cholesky_ex``, ``solve_triangular``, matmul), where the JAX
package ran XLA's in a ``scan``. The loop launches a few small kernels per
block step and never synchronizes the host; a failed factorization (the
``info`` of any step, combined on the device) turns the log-determinant
into NaN. The exact gradient is autograd through
the loop: its saved per-step tensors are a few ``(b, b)`` blocks per step
(about 1.2 GB in float64 at n = 2e5, b = 152), so no checkpointing is
needed.

``banded_loglike_fn``'s likelihood runs in the profiler spans
``banded.factor`` (the value table, the blocks, the block Cholesky) and
``banded.solve`` (the substitutions and the quadratic term), and its reverse
sweep in ``banded.backward``; ``block_steps`` counts the sequential block
steps enqueued (factor, forward and back substitution), on the host.
"""

import math

import torch

from ..diagnostics import annotate, backward_mark

__all__ = [
    "band_block_size",
    "band_blocks",
    "banded_cholesky",
    "banded_solve",
    "banded_sqrt_matvec",
    "banded_loglike_fn",
]

# sequential block steps enqueued by banded_cholesky (one a block) and
# banded_solve (two a block: forward and back substitution)
block_steps = 0


def band_block_size(n, offsets, multiple=8, max_block=512,
                    mem_budget=4 << 30, itemsize=8):
    """Block size for the block-tridiagonal view, or ``None`` when the
    direct path is not worthwhile (band too wide relative to ``n``, or the
    O(n b) block storage would blow the memory budget)."""
    w = max(int(offsets[-1]), -int(offsets[0]))
    b = max(multiple, -(-max(w, 1) // multiple) * multiple)
    if b > max_block or 2 * b >= n:
        return None
    nb = -(-n // b)
    # A + Ls + Cs + solve intermediates: ~4 (nb, b, b) arrays
    if 4 * nb * b * b * itemsize > mem_budget:
        return None
    return b


def band_blocks(vals, offsets, diag, b):
    """Block-tridiagonal view of the banded matrix ``K + diag(diag)``.

    ``vals``: ``(n, w)`` banded entries, ``vals[i, j] = K[i, i + offsets[j]]``
    (masked slots zero); ``offsets`` a contiguous integer range. ``n`` is
    padded up to a block multiple with unit diagonal (log-det contribution
    zero, solves act as identity on pad rows).

    Returns ``(A, Bs)``: diagonal blocks ``(nb, b, b)`` and sub-diagonal
    blocks ``Bs[i] = K[block i+1, block i]`` of shape ``(nb-1, b, b)``.
    """
    n, w = vals.shape
    d_min = int(offsets[0])
    nb = -(-n // b)
    pad = nb * b - n
    valsP = torch.nn.functional.pad(vals, (0, 0, 0, pad))
    diagP = torch.nn.functional.pad(diag, (0, pad), value=1.0)
    vb = valsP.reshape(nb, b, w)

    r = torch.arange(b, device=vals.device)[:, None]
    c = torch.arange(b, device=vals.device)[None, :]

    def block_of(dmap):
        j = dmap - d_min
        ok = (j >= 0) & (j < w)
        blk = vb[:, r, j.clamp(0, w - 1)]            # (nb, b, b)
        return torch.where(ok, blk, 0.0)

    A = block_of(c - r) + torch.diag_embed(diagP.reshape(nb, b))
    Bs = block_of(c - r - b)[1:]
    return A, Bs


def _chol(A):
    """Lower Cholesky factor of ``A`` and a device flag, true when the
    factorization failed (the factor's content is then unspecified)."""
    L, info = torch.linalg.cholesky_ex(A)
    return L, info != 0


def _lower_solve(L, B):
    return torch.linalg.solve_triangular(L, B, upper=False)


def banded_cholesky(A, Bs):
    """Block-tridiagonal Cholesky ``K + diag = W W^T``.

    Returns ``(Ls, Cs, logdet)``: per-block lower-triangular factors
    ``(nb, b, b)``, sub-diagonal factors ``(nb-1, b, b)``
    (``W = bidiag(Ls, Cs)``), and the exact log-determinant: NaN when any
    block step failed (the matrix is not positive definite), as the JAX
    package's NaN-filled factor gives.
    """
    global block_steps
    block_steps += A.shape[0]
    L, bad = _chol(A[0])
    Ls, Cs, failed = [L], [], [bad]
    for i in range(1, A.shape[0]):
        Ci = _lower_solve(Ls[-1], Bs[i - 1].mT).mT          # B L^{-T}
        Cs.append(Ci)
        L, bad = _chol(A[i] - Ci @ Ci.mT)
        Ls.append(L)
        failed.append(bad)
    Ls = torch.stack(Ls)
    Cs = torch.stack(Cs) if Cs else A.new_zeros((0,) + A.shape[1:])
    diags = torch.diagonal(Ls, dim1=-2, dim2=-1)
    logdet = 2.0 * torch.sum(torch.log(diags))
    logdet = torch.where(torch.stack(failed).any(),
                         logdet.new_tensor(math.nan), logdet)
    return Ls, Cs, logdet


def _block_rhs(y, b):
    squeeze = y.ndim == 1
    Y = y[:, None] if squeeze else y
    n, k = Y.shape
    nb = -(-n // b)
    Y = torch.nn.functional.pad(Y, (0, 0, 0, nb * b - n))
    return Y.reshape(nb, b, k), n, squeeze


def banded_solve(Ls, Cs, y):
    """``(K + diag)^{-1} y`` by forward + backward block substitution."""
    global block_steps
    b = Ls.shape[1]
    Y, n, squeeze = _block_rhs(y, b)
    nb = Ls.shape[0]
    block_steps += 2 * nb
    Z = [_lower_solve(Ls[0], Y[0])]
    for i in range(1, nb):
        Z.append(_lower_solve(Ls[i], Y[i] - Cs[i - 1] @ Z[-1]))
    W = [None] * nb
    W[-1] = torch.linalg.solve_triangular(Ls[-1].mT, Z[-1], upper=True)
    for i in range(nb - 2, -1, -1):
        W[i] = torch.linalg.solve_triangular(
            Ls[i].mT, Z[i] - Cs[i].mT @ W[i + 1], upper=True)
    out = torch.cat(W, dim=0)[:n]
    return out[:, 0] if squeeze else out


def banded_sqrt_matvec(Ls, Cs, y):
    """``W y`` with ``K + diag = W W^T`` (exact sampling transport):
    ``(Wy)_i = C_{i-1} y_{i-1} + L_i y_i`` — fully parallel, no loop."""
    b = Ls.shape[1]
    Y, n, squeeze = _block_rhs(y, b)
    out = torch.einsum("irc,icK->irK", Ls, Y)
    out[1:] += torch.einsum("irc,icK->irK", Cs, Y[:-1])
    flat = out.reshape(-1, out.shape[-1])[:n]
    return flat[:, 0] if squeeze else flat


def banded_loglike_fn(ell_values_fn, offsets, b, n_data):
    """Fused exact marginal likelihood for the banded path.

    Returns ``loglike(theta_kernel, diag, r)``: assemble the banded entry
    table, block Cholesky, block substitution, exact log-det. Exactly
    differentiable by autograd (no CG, no stochastic estimators).
    """

    def loglike(theta_k, diag, r):
        theta_k = backward_mark(theta_k)
        with annotate("banded.factor"):
            vals = ell_values_fn(theta_k)
            A, Bs = band_blocks(vals, offsets, diag, b)
            Ls, Cs, ld = banded_cholesky(A, Bs)
        with annotate("banded.solve"):
            z = banded_solve(Ls, Cs, r)
            quad = torch.dot(r, z)
        out = -0.5 * (quad + ld + n_data * math.log(2.0 * math.pi))
        return backward_mark(out, "banded.backward")

    return loglike
