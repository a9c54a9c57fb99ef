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
into NaN.

The likelihood's exact gradient is written by hand (:class:`_BandedLoglike`):
with ``K = W W^T`` (``W`` lower block-bidiagonal, diagonal blocks ``L_i``,
``C_i`` the block ``(i+1, i)``) and ``a = K^{-1} r``, ``d ll / d K =
1/2 (a a^T - K^{-1})`` and ``d ll / d r = -a``, and only the
block-tridiagonal band ``S`` of ``K^{-1}`` is read: the selected inverse,
by one backward recursion over the saved factors (the Takahashi
equations). With ``T_i = L_i^{-T} C_i^T`` and ``P_i = L_i^{-T} L_i^{-1}``
(each one batched launch over the blocks), ``S_{nb-1,nb-1} = P_{nb-1}``
and, from the last block down,

    ``X_i = T_i S_{i+1,i+1} = -S_{i,i+1}``;
    ``S_{i,i} = P_i + X_i T_i^T``

— two ``(b, b)`` products a step. The forward loops run inside the
Function, so autograd records no tape of them; the value table and
``band_blocks`` stay under autograd and carry the block gradients to the
kernel parameters and the diagonal.

``banded_loglike_fn``'s likelihood runs in the profiler spans
``banded.factor`` (the value table, the blocks, the block Cholesky) and
``banded.solve`` (the substitutions and the quadratic term, nested in it),
and its reverse sweep in ``banded.backward``; ``block_steps`` counts the
sequential block steps enqueued (factor, forward and back substitution)
and ``reverse_steps`` those of the selected-inverse recursion (``nb - 1``
a gradient), on the host.
"""

import math

import torch

from ..diagnostics import annotate, backward_mark
from .linalg import _per_member

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
# sequential steps enqueued by the selected-inverse recursion of the
# likelihood's reverse sweep (nb - 1 a gradient)
reverse_steps = 0


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
    # each step's info (nonzero: that step failed, and its factor's content
    # is unspecified), combined once on the device
    L, info = torch.linalg.cholesky_ex(A[0])
    Ls, Cs, infos = [L], [], [info]
    for i in range(1, A.shape[0]):
        Ci = _lower_solve(Ls[-1], Bs[i - 1].mT).mT          # B L^{-T}
        Cs.append(Ci)
        L, info = torch.linalg.cholesky_ex(A[i] - Ci @ Ci.mT)
        Ls.append(L)
        infos.append(info)
    Ls = torch.stack(Ls)
    Cs = torch.stack(Cs) if Cs else A.new_zeros((0,) + A.shape[1:])
    diags = torch.diagonal(Ls, dim1=-2, dim2=-1)
    logdet = 2.0 * torch.sum(torch.log(diags))
    logdet = torch.where(torch.stack(infos).ne(0).any(),
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


class _BandedLoglike(torch.autograd.Function):
    """``-1/2 (r^T (K + diag)^{-1} r + log det(K + diag))`` from the
    block-tridiagonal view ``(A, Bs)`` of ``band_blocks``, with the
    hand-written selected-inverse reverse sweep of the module docstring.

    Arguments: ``(A, Bs, r)``. Returns ``(value, Ls, Cs, alpha)``: the
    factors and the padded solution blocks ``(nb, b)`` are returned, not
    differentiable, so that ``torch.func`` can save them. The gradient in
    ``A`` is symmetric (torch's Cholesky backward's convention) and the one
    in ``Bs`` also stands for the upper blocks ``Bs^T``, which
    ``band_blocks`` never builds. Under ``torch.func.vmap`` the batch
    members run one after another; the backward is batched."""

    @staticmethod
    def forward(A, Bs, r):
        Ls, Cs, ld = banded_cholesky(A, Bs)
        with annotate("banded.solve"):
            alpha = banded_solve(Ls, Cs, r)
            value = -0.5 * (torch.dot(r, alpha) + ld)
            alpha = _block_rhs(alpha, Ls.shape[1])[0][..., 0]
        return value, Ls, Cs, alpha

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.n = inputs[2].shape[-1]
        ctx.save_for_backward(*output[1:])
        ctx.mark_non_differentiable(*output[1:])
        ctx.set_materialize_grads(False)    # no zero cotangents for those

    @staticmethod
    def vmap(info, in_dims, *args):
        return _per_member(_BandedLoglike.apply, info, in_dims, args)

    @staticmethod
    def backward(ctx, g, *_):
        global reverse_steps
        Ls, Cs, alpha = ctx.saved_tensors
        nb, b = Ls.shape[-3], Ls.shape[-1]
        reverse_steps += nb - 1
        # in float64 whatever the factors' dtype: the gradient's
        # cancellation (a a^T against S) magnifies the rounding of the
        # explicit inverses P and T about tenfold in float32. Each float64
        # stack is freed once it is last read.
        Ls, Cs, a = Ls.double(), Cs.double(), alpha.double()
        T = torch.linalg.solve_triangular(Ls[:-1].mT, Cs.mT, upper=True)
        Linv = _lower_solve(Ls, torch.eye(b, dtype=Ls.dtype,
                                          device=Ls.device))
        del Ls, Cs
        P = Linv.mT @ Linv
        del Linv
        S, X = [None] * nb, [None] * (nb - 1)
        S[-1] = P[-1].clone()
        for i in range(nb - 2, -1, -1):
            X[i] = T[i] @ S[i + 1]
            S[i] = torch.addmm(P[i], X[i], T[i].mT)
        del P
        S = torch.stack(S)
        X = torch.stack(X)
        dA = torch.baddbmm(S, a[:, :, None], a[:, None, :], beta=-1)
        dBs = torch.baddbmm(X.mT, a[1:, :, None], a[:-1, None, :])
        return (dA.mul_(0.5 * g).to(alpha.dtype), dBs.mul_(g).to(alpha.dtype),
                -g * alpha.reshape(-1)[:ctx.n])


def banded_loglike_fn(ell_values_fn, offsets, b, n_data):
    """Fused exact marginal likelihood for the banded path.

    Returns ``loglike(theta_kernel, diag, r)``: assemble the banded entry
    table, block Cholesky, block substitution, exact log-det
    (:class:`_BandedLoglike`). Exactly differentiable by autograd and
    ``torch.func`` (no CG, no stochastic estimators); the reverse sweep
    is the selected inverse's.
    """

    def loglike(theta_k, diag, r):
        theta_k = backward_mark(theta_k)
        with annotate("banded.factor"):
            vals = ell_values_fn(theta_k)
            A, Bs = band_blocks(vals, offsets, diag, b)
            out = _BandedLoglike.apply(A, Bs, r)[0]
        out = out - 0.5 * n_data * math.log(2.0 * math.pi)
        return backward_mark(out, "banded.backward")

    return loglike
