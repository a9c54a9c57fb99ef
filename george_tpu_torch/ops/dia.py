# -*- coding: utf-8 -*-
"""Banded (DIA) matrix times a block of right-hand sides, for the sparse
solver's fixed-theta applications of ``K + diag``.

Three pieces, one function ``out = diag * y + sum_j vals[:, j] * y[i +
offsets[j]]`` (``y`` zero outside ``[0, n)``):

* :func:`dia_matvec_cuda` launches the hand-written CUDA kernel
  (``csrc/dia.cu``) on CUDA tensors and counts the launch in
  :data:`dia_kernel_launches`;
* :func:`dia_matvec_plain` is the shifted-slice form of the JAX package's
  ``solvers/sparse.py::dia_apply`` in torch ops (pad, then one multiply-add
  per diagonal): it serves CPU tensors and is the yardstick the kernel is
  held against on the card;
* :func:`dia_matvec` dispatches on the tensors' device: the kernel for CUDA
  tensors (which never fall through to the plain version or a library
  call), the plain version for CPU tensors.

Kernel note. Replaces ``george_tpu/ops/dia.py::dia_matvec_pallas``. The
offsets are always a contiguous range ``d_min .. d_min + D - 1``
(``solvers/sparse.banded_offsets`` returns nothing else), so the kernel
takes ``(d_min, D)`` and the wrapper refuses anything else. It is memory
bound (about ``r/2`` flop per byte of the ``(n, D)`` value table against a
float32 ridge near 20); the design reads the table once for all ``r``
columns (the TPU kernel re-read it per column under ``vmap``), stages each
row tile's window of ``y`` in shared memory once, and writes each output
once. See ``csrc/dia.cu`` for the layout and its second, device-memory
variant for windows that do not fit shared memory.
"""

import numpy as np
import torch

__all__ = ["dia_matvec", "dia_matvec_plain", "dia_matvec_cuda",
           "band_range", "uses_shared_memory"]

# launches of the CUDA kernel in this process; only dia_matvec_cuda adds to
# it (read and reset it as ``george_tpu_torch.ops.dia.dia_kernel_launches``)
dia_kernel_launches = 0


def band_range(offsets):
    """``(d_min, D)`` of a contiguous offset range; raises ``ValueError``
    for any other offsets."""
    off = np.asarray(offsets, dtype=np.int64).ravel()
    if off.size == 0 or not np.array_equal(
            off, np.arange(off[0], off[0] + off.size)):
        raise ValueError("the DIA kernel takes a contiguous, increasing "
                         "offset range d_min..d_max, got %s" % (off,))
    return int(off[0]), int(off.size)


def dia_matvec_plain(vals, offsets, diag, y):
    """``(K + diag) y`` for the band ``vals`` ``(n, D)`` with diagonal
    ``offsets``, in torch ops: the JAX ``dia_apply`` recurrence (pad ``y``
    with zeros, then one shifted multiply-add per diagonal, in offset
    order). ``y``: ``(n,)`` or ``(n, r)``."""
    squeeze = y.ndim == 1
    Y = y[:, None] if squeeze else y
    n = Y.shape[0]
    offsets = [int(d) for d in np.asarray(offsets).ravel()]
    lo = max(-min(offsets), 0)
    hi = max(max(offsets), 0)
    Ypad = torch.nn.functional.pad(Y, (0, 0, lo, hi))
    out = diag[:, None] * Y
    for j, d in enumerate(offsets):
        out = out + vals[:, j:j + 1] * Ypad[lo + d:lo + d + n]
    return out[:, 0] if squeeze else out


def _check(vals, diag, y):
    for name, t in (("vals", vals), ("diag", diag), ("y", y)):
        if not t.is_cuda:
            raise ValueError("dia_matvec_cuda needs CUDA tensors, %s is on %s"
                             % (name, t.device))
        if t.dtype != vals.dtype or t.device != vals.device:
            raise ValueError("dia_matvec_cuda: %s is %s on %s, vals is %s "
                             "on %s" % (name, t.dtype, t.device, vals.dtype,
                                        vals.device))
        if not t.is_contiguous():
            raise ValueError("dia_matvec_cuda takes contiguous tensors; %s "
                             "is not" % name)
    if vals.dtype not in (torch.float32, torch.float64):
        raise TypeError("dia_matvec_cuda takes float32 or float64, got %s"
                        % vals.dtype)
    n = vals.shape[0]
    if (vals.ndim != 2 or diag.shape != (n,) or y.ndim not in (1, 2)
            or y.shape[0] != n):
        raise ValueError("dia_matvec_cuda takes vals (n, D), diag (n,) and y "
                         "(n,) or (n, r); got %s, %s, %s"
                         % (tuple(vals.shape), tuple(diag.shape),
                            tuple(y.shape)))


def dia_matvec_cuda(vals, offsets, diag, y):
    """Launch the CUDA kernel: ``(K + diag) y`` on contiguous float32 or
    float64 CUDA tensors; raises on any launch error."""
    global dia_kernel_launches
    _check(vals, diag, y)
    d_min, D = band_range(offsets)
    if D != vals.shape[1]:
        raise ValueError("%d offsets for a value table of %d columns"
                         % (D, vals.shape[1]))
    from ._build import load

    lib = load()
    out = torch.empty_like(y)
    n = y.shape[0]
    r = 1 if y.ndim == 1 else y.shape[1]
    if n == 0 or r == 0:
        return out
    fn = lib.george_dia_f32 if y.dtype == torch.float32 else lib.george_dia_f64
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        err = fn(vals.data_ptr(), diag.data_ptr(), y.data_ptr(),
                 out.data_ptr(), n, D, d_min, r, stream)
    if err != 0:
        raise RuntimeError("dia kernel launch failed for n=%d D=%d r=%d %s: "
                           "cudaError %d" % (n, D, r, y.dtype, err))
    dia_kernel_launches += 1
    return out


def uses_shared_memory(D, r, dtype, device=None):
    """Whether a band of ``D`` diagonals times ``r`` columns takes the
    kernel's shared-memory variant (else its device-memory variant) on
    ``device``."""
    from ._build import load

    size = torch.empty((), dtype=dtype).element_size()
    with torch.cuda.device(device):
        return bool(load().george_dia_uses_smem(int(D), int(r), size))


def dia_matvec(vals, offsets, diag, y):
    """``(K + diag) y`` for a band: the CUDA kernel on CUDA tensors, the
    plain version on CPU tensors."""
    if y.is_cuda:
        return dia_matvec_cuda(vals.contiguous(), offsets, diag.contiguous(),
                               y.contiguous())
    if y.device.type == "cpu":
        return dia_matvec_plain(vals, offsets, diag, y)
    raise ValueError("no DIA matvec for device %s" % y.device)
