# -*- coding: utf-8 -*-
"""Batched Cholesky of the hierarchical solver's leaf boxes.

Three pieces, one function:

* :func:`cholesky_cuda` launches the hand-written CUDA kernel
  (``csrc/chol.cu``) on a CUDA tensor and counts the launch in
  :data:`chol_kernel_launches`;
* :func:`cholesky_plain` is the same right-looking column recurrence, with
  the same ``1e-30`` pivot floor, in torch tensor ops: it serves CPU
  tensors and is the yardstick the kernel is held against on the card
  (``panel=PANEL`` defers the trailing update per panel of columns as the
  kernel does; ``panel=1``, the default, updates after every column);
* :func:`cholesky` is the differentiable entry point the solver calls. Its
  forward takes the kernel for a CUDA tensor and the plain version for a
  CPU tensor — a CUDA tensor never falls through to the plain version or
  to a library Cholesky — and its backward is the standard Cholesky
  pullback ``A_bar = L^-T Phi(L^T L_bar) L^-1``, symmetrized, from
  triangular solves (as in ``george_tpu/ops/chol.py``, whose backward is
  XLA triangular solves too).

Kernel note. Replaces ``george_tpu/ops/chol.py::pallas_cholesky_blocked``
(the Pallas panel kernel of the TPU build). What it computes is the TPU
kernel's function: lower ``L`` with ``L L^T = A`` per SPD block, the
per-column ``rsqrt(max(d_kk, 1e-30))`` pivot, the upper triangle as exact
zeros, and no identity padding of ``m``. What bounds it on the card is the
chain of ``m`` dependent column steps per block, not bytes or FLOPs (35 us
and 19 us at the main path's 512 blocks of m=196, f32), with a barrier
between steps if they were taken column by column. The kernel cuts the
chain's cost by panels of 32 columns: one warp factors the panel's
diagonal block in registers (a barrier-free 32-step chain), the rows below
are solved one per thread, and the trailing triangle takes one
register-tiled rank-32 update per panel, so a block crosses about
``3m/32`` barriers instead of ``2m``.
The next panel's diagonal block is updated first, so that warp 0 factors it
while the other warps finish the update. The Schur complement keeps only
its packed lower triangle in shared memory (77 KB at f32 m=196: two blocks
per SM), or its in-place rows in device memory when that does not fit (f32
m=489), read and written once per panel.

Second kernel, :func:`cholesky_tiled_cuda` (counter
:data:`chol_tile_kernel_launches`). Replaces
``george_tpu/ops/chol.py::pallas_cholesky``, the unblocked kernel that
factors ``block_tile`` blocks per grid step; it is on no solver path (its
one caller in the JAX package is a test), so nothing here routes to it.
Same function and the same device routine; only the launch plan differs.
The plan (:func:`launch_plan`, computed here and passed to the C launcher)
gives each block a group of warps and packs groups into CTAs: many warps
on one block when the batch is small, as at (8, 128); a few warps per
block and several blocks per CTA when it is large, as at (1024, 64).
"""

import ctypes
from collections import namedtuple

import torch

__all__ = ["cholesky", "cholesky_plain", "cholesky_cuda",
           "cholesky_tiled_cuda", "launch_plan", "PANEL"]

# launches of the CUDA kernel in this process; only cholesky_cuda adds to
# it (read and reset it as ``george_tpu_torch.ops.chol.chol_kernel_launches``)
chol_kernel_launches = 0
# launches of the tiled kernel; only cholesky_tiled_cuda adds to it
chol_tile_kernel_launches = 0

_TINY = 1e-30
PANEL = 32                   # the kernel's panel width (kNB in chol.cu)
MAX_CTA_THREADS = 512        # the kernel's launch bound
MAX_BLOCKS_PER_CTA = 16      # one named barrier per block, ids 0..15
CTA_RESERVED_SMEM = 1024     # shared bytes the card reserves per CTA


DeviceLimits = namedtuple("DeviceLimits",
                          "smem_per_cta smem_per_sm sm_count")
# the H100 SXM's: 227 KB opt-in per CTA, 228 KB per SM, 132 SMs
H100 = DeviceLimits(232448, 233472, 132)
# the plan's variants as csrc/chol.cu numbers them
_VARIANTS = {"device": 0, "shared": 1, "device-panel": 2}
LaunchPlan = namedtuple(
    "LaunchPlan",
    "variant group_threads blocks_per_cta cta_threads smem_bytes grid")


def _warps_per_sm(dtype, variant):
    """Warps an SM holds at the kernel's register cap (its launch bounds:
    at most 64 registers a thread for f32 in device memory, 128 else)."""
    return 32 if dtype == torch.float32 and variant != "shared" else 16


def cholesky_plain(A, panel=1):
    """Batched lower Cholesky of SPD ``A`` ``(B, m, m)`` in torch ops: the
    kernel's right-looking recurrence and pivot floor. Within a panel of
    ``panel`` columns each column updates the panel's later columns; the
    columns right of the panel take the panel's update once, after it
    (``panel=1``: every column updates the whole trailing block)."""
    S = A.clone()
    L = torch.zeros_like(A)
    m = A.shape[-1]
    for k0 in range(0, m, panel):
        k1 = min(k0 + panel, m)
        hi = m if panel == 1 else k1
        for k in range(k0, k1):
            inv = torch.rsqrt(torch.clamp_min(S[:, k, k], _TINY))
            col = S[:, k:, k] * inv[:, None]              # (B, m - k)
            L[:, k:, k] = col
            tail = col[:, 1:]
            S[:, k + 1:, k + 1:hi] -= (tail[:, :, None]
                                       * tail[:, None, :hi - k - 1])
        if hi < m:
            P = L[:, k1:, k0:k1]
            S[:, k1:, k1:] -= P @ P.mT
    return L


def _panel_elems(m):
    """Elements of one block's panel workspace (``csrc/chol.cu``): the
    transposed panel ``(PANEL, m rounded up to 4)``, the diagonal block and
    its pivots (padded to 16 bytes)."""
    return PANEL * (-(-m // 4) * 4 + PANEL + 1) + PANEL


def _group_bytes(m, itemsize, variant):
    """Shared bytes one block takes (the layout of ``csrc/chol.cu``): the
    packed lower triangle, rounded up to 16 bytes (shared variant only),
    and the panel workspace (not in the device-panel variant)."""
    if variant == "device-panel":
        return 0
    tri = 0
    if variant == "shared":
        tri = -(-(m * (m + 1) // 2 * itemsize) // 16) * 16
    return tri + _panel_elems(m) * itemsize


def launch_plan(B, m, dtype, tiled=False, limits=None):
    """The kernel's launch geometry for ``B`` blocks of order ``m``.

    ``variant`` is ``"shared"`` when a block's packed triangle fits the
    per-CTA limit, else ``"device"`` (the triangle in place in the output,
    the panel in shared memory), else ``"device-panel"`` (the panel too in
    a scratch buffer, for m past ~1780 in f32, ~870 in f64). The leaf plan
    (``tiled=False``) puts one block in each CTA and gives it as many warps
    as the SM's warp slots divided by the CTAs its shared memory lets
    reside; the tiled plan spreads the card's warp slots over the batch
    and packs several blocks into a CTA when the batch is large. Warps past
    the first trailing update's tile count, one 4 x 4 tile a thread, would
    idle and are not asked for. ``limits`` defaults to the current
    device's."""
    if limits is None:
        limits = device_limits()
    size = dtype.itemsize
    tiles = -(-max(m - PANEL, 0) // 4)
    busy = max(1, min(MAX_CTA_THREADS // 32, -(-tiles * (tiles + 1) // 64)))
    for variant in ("shared", "device"):
        per_block = _group_bytes(m, size, variant)
        if per_block <= limits.smem_per_cta:
            break
    else:
        return LaunchPlan("device-panel", 32 * busy, 1, 32 * busy, 0, B)
    slots = _warps_per_sm(dtype, variant)
    if tiled:
        warps = max(1, min(busy, limits.sm_count * slots // max(B, 1)))
        per_cta = max(1, min(MAX_CTA_THREADS // (32 * warps),
                             MAX_BLOCKS_PER_CTA,
                             limits.smem_per_cta // per_block,
                             -(-B // limits.sm_count)))
    else:
        resident = max(1, limits.smem_per_sm
                       // (per_block + CTA_RESERVED_SMEM))
        warps = max(1, min(busy, slots // resident))
        per_cta = 1
    return LaunchPlan(variant, 32 * warps, per_cta, 32 * warps * per_cta,
                      per_cta * per_block, -(-B // per_cta))


_limits = {}


def device_limits(device=None):
    """The launch plan's limits of a CUDA device, read by the kernel
    library (opt-in shared bytes per CTA, shared bytes per SM, SMs)."""
    from ._build import load

    index = None if device is None else torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    if index not in _limits:
        out = (ctypes.c_int * 3)()
        with torch.cuda.device(index):
            err = load().george_chol_device_limits(out)
        if err != 0:
            raise RuntimeError("device limits query failed: cudaError %d"
                               % err)
        _limits[index] = DeviceLimits(*out)
    return _limits[index]


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


def _launch(A, name, fn_name, tiled):
    _check(A, name)
    from ._build import load

    lib = load()
    L = torch.empty_like(A)
    B, m, _ = A.shape
    if B == 0 or m == 0:
        return L, False
    plan = launch_plan(B, m, A.dtype, tiled, device_limits(A.device))
    scratch = None
    if plan.variant == "device-panel":
        scratch = torch.empty(B * _panel_elems(m),
                              dtype=A.dtype, device=A.device)
    fn = getattr(lib, fn_name % (32 if A.dtype == torch.float32 else 64))
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        err = fn(A.data_ptr(), L.data_ptr(),
                 None if scratch is None else scratch.data_ptr(), B, m,
                 _VARIANTS[plan.variant], plan.group_threads,
                 plan.blocks_per_cta, plan.smem_bytes, stream)
    if err != 0:
        raise RuntimeError("%s launch failed for (%d, %d) %s with %s: "
                           "cudaError %d" % (name, B, m, A.dtype, plan, err))
    return L, True


def cholesky_cuda(A):
    """Launch the CUDA kernel on ``A`` ``(B, m, m)`` (float32 or float64,
    contiguous, on a CUDA device) with the leaf plan; raises on any launch
    error."""
    global chol_kernel_launches
    L, launched = _launch(A, "cholesky_cuda", "george_chol_f%d", False)
    chol_kernel_launches += int(launched)
    return L


def cholesky_tiled_cuda(A):
    """Launch the kernel with the tiled plan (a group of warps per block,
    several blocks per CTA when the batch is large) on ``A`` ``(B, m, m)``;
    same contract as :func:`cholesky_cuda`."""
    global chol_tile_kernel_launches
    L, launched = _launch(A, "cholesky_tiled_cuda", "george_chol_tile_f%d",
                          True)
    chol_tile_kernel_launches += int(launched)
    return L


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
    """The batched Cholesky as a Function that ``torch.func`` transforms
    compose with. Under ``vmap`` the mapped dimension is folded into the
    kernel's batch: ``(C, B, m, m)`` is one launch of ``(C * B, m, m)``
    (the counterpart of JAX's ``vmap`` of the ``custom_vjp`` around the
    Pallas kernel), so a batch of chains costs one leaf launch per
    evaluation. The backward is torch ops, which batch on their own."""

    @staticmethod
    def forward(A):
        return _forward(A)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(output)

    @staticmethod
    def vmap(info, in_dims, A):
        A = A.movedim(in_dims[0], 0)
        C, B, m, _ = A.shape
        L = _Cholesky.apply(A.reshape(C * B, m, m))
        return L.reshape(C, B, m, m), 0

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
