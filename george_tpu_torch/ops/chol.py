# -*- coding: utf-8 -*-
"""Batched Cholesky of the hierarchical solver's leaf boxes.

Three pieces, one function:

* :func:`cholesky_cuda` launches the hand-written CUDA kernel
  (``csrc/chol.cu``) on a CUDA tensor and counts the launch in
  :data:`chol_kernel_launches`;
* :func:`cholesky_plain` is the same right-looking column recurrence, with
  the same ``1e-30`` pivot floor, in torch tensor ops: it serves CPU
  tensors and is the yardstick the kernel is held against on the card;
* :func:`cholesky` is the differentiable entry point the solver calls. Its
  forward takes the kernel for a CUDA tensor and the plain version for a
  CPU tensor — a CUDA tensor never falls through to the plain version or
  to a library Cholesky — and its backward is the standard Cholesky
  pullback ``A_bar = L^-T Phi(L^T L_bar) L^-1``, symmetrized, from
  triangular solves (as in ``george_tpu/ops/chol.py``, whose backward is
  XLA triangular solves too).

Kernel note. Replaces ``george_tpu/ops/chol.py::pallas_cholesky_blocked``
(the Pallas panel kernel of the TPU build). What it computes is the TPU
kernel's function, not its block structure: lower ``L`` with ``L L^T = A``
per SPD block, the per-column ``rsqrt(max(d_kk, 1e-30))`` pivot, the upper
triangle as exact zeros, and no identity padding of ``m``. What bounds it
at the main path's shape (512 blocks of m=196): each block is a chain of
196 dependent column steps, one CTA per block with one 150 KB shared-memory
CTA resident per SM, so the 512 blocks run in about four waves over the
card's 132 SMs, each wave as long as one block's serial chain. A later
version would shorten the chain's per-step cost with panel blocking (a
barrier per panel of columns, the trailing update as a small GEMM in full
FP32) and raise occupancy by packing several small blocks into one CTA.

Second kernel, :func:`cholesky_tiled_cuda` (counter
:data:`chol_tile_kernel_launches`). Replaces
``george_tpu/ops/chol.py::pallas_cholesky``, the unblocked kernel that
factors ``block_tile`` blocks per grid step; it is on no solver path (its
one caller in the JAX package is a test), so nothing here routes to it.
Same function, same recurrence, same pivot floor: ``cholesky_plain`` is the
plain version of both kernels. Its layout is one warp per block and several
blocks per CTA, each column step warp-synchronous; a block sits in shared
memory when it fits (f32 m <= 128: 3 per CTA) and in device memory
otherwise. Its floor on the card is the bytes: read A and write L,
``2 * B * m * m`` words.
"""

import torch

__all__ = ["cholesky", "cholesky_plain", "cholesky_cuda",
           "cholesky_tiled_cuda"]

# launches of the CUDA kernel in this process; only cholesky_cuda adds to
# it (read and reset it as ``george_tpu_torch.ops.chol.chol_kernel_launches``)
chol_kernel_launches = 0
# launches of the tiled kernel; only cholesky_tiled_cuda adds to it
chol_tile_kernel_launches = 0

_TINY = 1e-30


def cholesky_plain(A):
    """Batched lower Cholesky of SPD ``A`` ``(B, m, m)`` in torch ops: the
    kernel's right-looking recurrence and pivot floor, step for step."""
    S = A.clone()
    L = torch.zeros_like(A)
    m = A.shape[-1]
    for k in range(m):
        inv = torch.rsqrt(torch.clamp_min(S[:, k, k], _TINY))
        col = S[:, k:, k] * inv[:, None]                  # (B, m - k)
        L[:, k:, k] = col
        tail = col[:, 1:]
        S[:, k + 1:, k + 1:] -= tail[:, :, None] * tail[:, None, :]
    return L


def _check(A, name):
    if not A.is_cuda:
        raise ValueError("%s needs a CUDA tensor, got %s" % (name, A.device))
    if A.dtype not in (torch.float32, torch.float64):
        raise TypeError("%s takes float32 or float64, got %s"
                        % (name, A.dtype))
    if A.ndim != 3 or A.shape[1] != A.shape[2]:
        raise ValueError("%s takes square blocks (B, m, m), got shape %s"
                         % (name, tuple(A.shape)))
    if not A.is_contiguous():
        raise ValueError("%s takes a contiguous tensor" % name)


def _launch(A, name, f32, f64):
    _check(A, name)
    from ._build import load

    lib = load()
    L = torch.empty_like(A)
    B, m, _ = A.shape
    if B == 0 or m == 0:
        return L, False
    fn = getattr(lib, f32 if A.dtype == torch.float32 else f64)
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        err = fn(A.data_ptr(), L.data_ptr(), B, m, stream)
    if err != 0:
        raise RuntimeError("%s launch failed for (%d, %d) %s: cudaError %d"
                           % (name, B, m, A.dtype, err))
    return L, True


def cholesky_cuda(A):
    """Launch the CUDA kernel on ``A`` ``(B, m, m)`` (float32 or float64,
    contiguous, on a CUDA device); raises on any launch error."""
    global chol_kernel_launches
    L, launched = _launch(A, "cholesky_cuda", "george_chol_f32",
                          "george_chol_f64")
    chol_kernel_launches += int(launched)
    return L


def cholesky_tiled_cuda(A):
    """Launch the tiled kernel (one warp per block, several blocks per CTA)
    on ``A`` ``(B, m, m)``; same contract as :func:`cholesky_cuda`."""
    global chol_tile_kernel_launches
    L, launched = _launch(A, "cholesky_tiled_cuda", "george_chol_tile_f32",
                          "george_chol_tile_f64")
    chol_tile_kernel_launches += int(launched)
    return L


def uses_shared_memory(m, dtype, device=None):
    """Whether blocks of order ``m`` take the kernel's shared-memory
    variant (else its in-place device-memory variant) on ``device``."""
    from ._build import load

    size = torch.empty((), dtype=dtype).element_size()
    with torch.cuda.device(device):
        return bool(load().george_chol_uses_smem(int(m), size))


def tile_blocks_per_cta(m, dtype, device=None):
    """Blocks of order ``m`` per CTA in the tiled kernel's shared-memory
    variant on ``device``; 0 means its device-memory variant."""
    from ._build import load

    size = torch.empty((), dtype=dtype).element_size()
    with torch.cuda.device(device):
        return int(load().george_chol_tile_blocks_per_cta(int(m), size))


def _forward(A):
    if A.is_cuda:
        return cholesky_cuda(A.contiguous())
    if A.device.type == "cpu":
        return cholesky_plain(A)
    raise ValueError("no Cholesky for device %s" % A.device)


def _phi(X):
    """Lower triangle with halved diagonal (the pullback's projection)."""
    return torch.tril(X) - 0.5 * torch.diag_embed(
        torch.diagonal(X, dim1=-2, dim2=-1)
    )


class _Cholesky(torch.autograd.Function):

    @staticmethod
    def forward(ctx, A):
        L = _forward(A)
        ctx.save_for_backward(L)
        return L

    @staticmethod
    def backward(ctx, Lbar):
        (L,) = ctx.saved_tensors
        Lt = L.mT

        def solve_LT(X):                  # L^-T X
            return torch.linalg.solve_triangular(Lt, X, upper=True)

        P = _phi(Lt @ Lbar)
        S = solve_LT(solve_LT(P.mT).mT)
        return 0.5 * (S + S.mT)


def cholesky(A):
    """Differentiable batched lower Cholesky of ``A`` ``(B, m, m)``: the
    CUDA kernel on a CUDA tensor, the plain recurrence on a CPU tensor."""
    if A.ndim != 3:
        raise ValueError("cholesky takes a batch (B, m, m), got shape %s"
                         % (tuple(A.shape),))
    return _Cholesky.apply(A)
