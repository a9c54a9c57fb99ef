# -*- coding: utf-8 -*-
"""Banded (DIA) matrix times a block of right-hand sides, for the sparse
solver's fixed-theta applications of ``K + diag``.

One function, ``out = diag * y + sum_j vals[:, j] * y[i + offsets[j]]``
(``y`` zero outside ``[0, n)``), in these pieces:

* :func:`dia_matvec_cuda` launches the hand-written CUDA kernel
  (``csrc/dia.cu``) on CUDA tensors, after checking everything about them,
  and counts the launch in :data:`dia_kernel_launches`;
* :class:`DiaOperator` is the same launch for a caller that applies one
  band many times (the sparse solver's CG, Lanczos and tangent applies):
  the offsets are checked once when it is made, and a call goes from the
  tensors to the launch in some twenty microseconds of host time (the
  launch plan and the bound C function of each shape are made once per
  process and looked up after that);
* :func:`launch_plan` computes the kernel's launch geometry from
  ``(n, D, r, dtype)`` and the card's limits, in Python, once per shape;
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
takes ``(d_min, D)`` and the wrapper refuses anything else. What bounds it
on the card is device memory: the ``(n, D)`` value table is read once
(241 MB at n = 2e5, D = 301, float32, about ``r/2`` flop per byte against a
float32 ridge near 20). The design keeps the table streaming and everything
else out of its way: tiles of the table arrive in a ring of shared-memory
stages by asynchronous bulk copies (``cp.async.bulk`` on ``mbarrier``s)
started by one thread of a persistent CTA; the window of ``y`` is staged
row-major once per item of several tiles; and with several columns a
thread owns 4 rows x 4 columns (2 in float64) of one band segment, so that
one 16-byte shared-memory load and four table words feed 16 FMAs (the TPU
kernel re-read the table per column under ``vmap``; the port's first kernel
took one shared-memory load per FMA). See ``csrc/dia.cu`` for the layout
and for the plain device-memory kernel that serves windows too large for
shared memory.
"""

import ctypes
import functools
from collections import namedtuple

import numpy as np
import torch

from .chol import CTA_RESERVED_SMEM, H100, device_limits

__all__ = ["dia_matvec", "dia_matvec_plain", "dia_matvec_cuda",
           "DiaOperator", "DiaPlan", "launch_plan", "band_range",
           "uses_shared_memory", "stream_width", "H100"]

# launches of the CUDA kernel in this process; only the launch shared by
# dia_matvec_cuda and DiaOperator adds to it (read and reset it as
# ``george_tpu_torch.ops.dia.dia_kernel_launches``)
dia_kernel_launches = 0

MAX_CTA_THREADS = 512        # the streaming kernel's launch bound
MIN_CTA_THREADS = 256        # what the plan tries to give a CTA to do
MAX_STAGES = 4               # ring depth asked for at most (kernel: 8)
BARRIER_BYTES = 64           # the ring's mbarriers, ahead of the window
ITEM_ROWS = 128              # rows that share one staged window of y
ROW_TILE = 4                 # rows a thread owns when r > 1
DEVICE_ROWS, DEVICE_THREADS = 128, 256   # the device-memory kernel's CTA
DEVICE_COLS = 16             # its columns per pass over a row (kDevCols)


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


# ---------------------------------------------------------------------------
# the launch plan
# ---------------------------------------------------------------------------

DiaPlan = namedtuple(
    "DiaPlan",
    "variant row_tile col_tile segments tile_rows stages tiles_per_item "
    "seg_len win_stride groups passes win_off ring_off stage_bytes "
    "smem_bytes threads grid ctas_per_sm")
_VARIANTS = {"device": 0, "stream": 1}


def _wavefronts(addresses, width):
    """Shared-memory wavefronts of one warp-wide load: ``addresses`` are the
    lanes' first 4-byte words, ``width`` the words each lane loads (1, 2 or
    4). The hardware serves 32 / width lanes at a time; lanes of one such
    phase that need different words of one bank take a wavefront each."""
    lanes = 32 // width
    total = 0
    for p in range(0, len(addresses), lanes):
        words = {a + k for a in addresses[p:p + lanes] for k in range(width)}
        per_bank = [0] * 32
        for w in words:
            per_bank[w % 32] += 1
        total += max(per_bank)
    return total


def _conflicts(D, R, C, nseg, groups, seg_len, stride, words):
    """Wavefronts of the first warp's two loads of a diagonal step (the
    window row and one table entry) for a candidate ``(seg_len, stride)``;
    ``words`` is the element size in 4-byte words. The thread layout is the
    kernel's: segment fastest, then column group, then row group."""
    ywords, vwords = [], []
    for lane in range(32):
        seg, grp = lane % nseg, lane // nseg
        cg, rg = grp % groups, grp // groups
        row = rg * R
        ywords.append(((row + seg * seg_len) * stride + cg * C) * words)
        vwords.append((row * D + seg * seg_len) * words)
    ywidth = min(4, C * words)
    loads = C * words // ywidth
    return (sum(_wavefronts([a + k * ywidth for a in ywords], ywidth)
                for k in range(loads))
            + R * _wavefronts(vwords, words))


@functools.lru_cache(maxsize=1024)
def _segments_and_stride(D, R, C, nseg, groups, columns, size):
    """The segment length (from ``ceil(D / nseg)`` up) and the window's row
    stride (from ``columns`` up, in elements of ``size`` bytes) with the
    fewest bank conflicts, the smaller stride and length among equals."""
    vec = 16 // size
    # 16-byte loads of the window need a stride that keeps them aligned
    step = vec if C % vec == 0 else 1
    width = -(-columns // step) * step
    seg0 = -(-D // nseg)
    return min(
        ((s, w) for s in range(seg0, seg0 + 4)
         for w in range(width, width + 8 * step + 1, step)),
        key=lambda sw: (_conflicts(D, R, C, nseg, groups, sw[0], sw[1],
                                   size // 4), sw[1], sw[0]))


def launch_plan(n, D, r, dtype, limits=None, tile_rows=None, stages=None,
                ctas_per_sm=None, segments=None, item_rows=None):
    """The DIA kernel's launch geometry for a band of ``D`` diagonals over
    ``n`` rows times ``r`` columns.

    ``variant`` is ``"stream"`` (the table streamed through a shared-memory
    ring, ``y``'s window in shared memory) whenever two ring stages of the
    smallest tile and the window fit a CTA's shared memory, else
    ``"device"`` (``y`` read from device memory). The streaming plan: a
    thread owns ``row_tile x col_tile`` outputs of one of ``segments`` band
    segments of ``seg_len`` diagonals; ``groups`` column groups work at
    once and cover the ``ceil(r / col_tile)`` groups in ``passes`` passes;
    a ring stage holds ``tile_rows`` rows of the table (``stage_bytes``, a
    multiple of 16 whatever ``D`` is); ``tiles_per_item`` tiles share one
    window of ``y`` of row stride ``win_stride`` elements; ``seg_len`` and
    ``win_stride`` are the pair with the fewest shared-memory bank
    conflicts. ``limits`` defaults to the current device's; the keyword
    arguments after it override a choice (for tuning sweeps).
    """
    if limits is None:
        limits = device_limits()
    size = dtype.itemsize
    vec = 16 // size                         # elements of a 16-byte load
    if n <= 0 or r <= 0 or D <= 0:
        raise ValueError("launch_plan takes positive n, D, r; got %r"
                         % ((n, D, r),))
    R = 1 if r == 1 else ROW_TILE
    C = 1 if r == 1 else vec
    col_groups = -(-r // C)
    item_rows = item_rows or ITEM_ROWS

    def geometry(T, resident):
        """The plan at ``T`` rows a tile and ``resident`` CTAs per SM, or
        None if it does not fit."""
        budget = min(limits.smem_per_cta,
                     limits.smem_per_sm // resident - CTA_RESERVED_SMEM)
        row_groups = T // R
        # more band segments when few column groups would leave the CTA
        # with few threads
        nseg = segments or 8
        while (segments is None and nseg < 32
               and nseg * col_groups * row_groups < MIN_CTA_THREADS):
            nseg *= 2
        fit = MAX_CTA_THREADS // (nseg * row_groups)
        if fit < 1:
            return None
        passes = -(-col_groups // fit)
        groups = -(-col_groups // passes)
        tiles = max(1, item_rows // T)
        seg_len, stride = _segments_and_stride(D, R, C, nseg, groups,
                                               col_groups * C, size)
        win_bytes = -(-(tiles * T + D - 1) * stride * size // 16) * 16
        stage_bytes = T * D * size
        room = (budget - BARRIER_BYTES - win_bytes) // stage_bytes
        depth = min(stages or MAX_STAGES, room)
        if depth < 2:
            return None
        ring_off = BARRIER_BYTES + win_bytes
        return DiaPlan(
            "stream", R, C, nseg, T, depth, tiles, seg_len, stride, groups,
            passes, BARRIER_BYTES, ring_off, stage_bytes,
            ring_off + depth * stage_bytes, nseg * groups * row_groups,
            min(-(-n // (tiles * T)), resident * limits.sm_count), resident)

    smallest = max(R, vec)
    tiles = ([tile_rows] if tile_rows
             else [t for t in (32, 16, 8, 4, 2) if t >= smallest])
    residents = [ctas_per_sm] if ctas_per_sm else [2, 1]
    # most bytes of the table in flight per SM (up to 128 KB), then two CTAs
    # an SM (each hides the other's window staging and barriers: 0.147
    # against 0.20 ms at r = 16 on the bench band; deeper rings added
    # nothing), then the larger tile
    best = None
    for T in tiles:
        for resident in residents:
            plan = geometry(T, resident)
            if plan is None:
                continue
            flight = plan.stages * plan.stage_bytes * resident
            key = (min(flight, 128 * 1024), resident, T)
            if best is None or key > best[0]:
                best = (key, plan)
    if best is not None:
        return best[1]
    return DiaPlan("device", 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                   DEVICE_THREADS, -(-n // DEVICE_ROWS), 0)


def _plan_words(plan, bulk):
    """The plan as the C launcher reads it (``csrc/dia.cu::launch``)."""
    return (ctypes.c_int * 18)(
        _VARIANTS[plan.variant], plan.row_tile, plan.col_tile, plan.segments,
        plan.tile_rows, plan.stages, plan.tiles_per_item, plan.seg_len,
        plan.win_stride, plan.groups, plan.passes, plan.win_off,
        plan.ring_off, plan.stage_bytes, int(bulk), plan.smem_bytes,
        plan.threads, plan.grid)


def uses_shared_memory(D, r, dtype, device=None, limits=None):
    """Whether a band of ``D`` diagonals times ``r`` columns takes the
    kernel's streaming variant (the table and ``y``'s window through shared
    memory) or its device-memory variant, on ``device`` or under
    ``limits``: read from the plan."""
    if limits is None:
        limits = device_limits(device)
    return launch_plan(1 << 20, D, r, dtype, limits).variant == "stream"


def stream_width(n, D, r, dtype, limits=None):
    """The columns one launch of an ``(n, r)`` block over ``D`` diagonals
    takes: ``r`` when the streaming plan takes all of them; else ``w``,
    the widest width such that the streaming plan takes every width from
    ``DEVICE_COLS`` to ``w`` (launches that walk the table no more often
    than the device-memory kernel's passes over a row do); else ``r``
    (the device-memory kernel, kept simple, not fast). ``limits``
    defaults to the current device's."""
    if limits is None:
        limits = device_limits()

    def streams(w):
        return launch_plan(n, D, w, dtype, limits).variant == "stream"

    if streams(r):
        return r
    w = DEVICE_COLS - 1
    while w + 1 < r and streams(w + 1):
        w += 1
    return w if w >= DEVICE_COLS else r


# ---------------------------------------------------------------------------
# the launch
# ---------------------------------------------------------------------------

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


# torch's raw accessor to a device's current stream, where this build has
# it: it skips making a ``Stream`` object (6 to 8 microseconds on the H100's
# host, on a path CG takes hundreds of times)
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _current_stream(index):
    """The current stream of device ``index`` as the integer the C launcher
    takes."""
    if _raw_stream is not None:
        return _raw_stream(index)
    return torch.cuda.current_stream(index).cuda_stream


_prepared = set()     # device indices whose kernels took their shared memory


def _bind(n, D, r, dtype, index, aligned, plan=None):
    """What one launch shape needs besides the tensors: the C function, the
    plan as the launcher reads it, and the plan (``launch_plan``'s for the
    device unless one is given)."""
    from ._build import load

    lib = load()
    if index not in _prepared:
        with torch.cuda.device(index):
            err = lib.george_dia_prepare()
        if err != 0:
            raise RuntimeError("dia kernel set-up failed on cuda:%d: "
                               "cudaError %d" % (index, err))
        _prepared.add(index)
    if plan is None:
        plan = launch_plan(n, D, r, dtype, device_limits(index))
    fn = lib.george_dia_f32 if dtype == torch.float32 else lib.george_dia_f64
    return fn, _plan_words(plan, aligned), plan


# each launch shape is bound once per process (the words are never written)
_bound = functools.lru_cache(maxsize=256)(_bind)


def _launch(vals, diag, y, d_min, D, entry=None):
    """Launch the kernel on tensors already known to be fit for it, with
    the shape's default binding unless ``entry`` (what :func:`_bind`
    returns) is given."""
    global dia_kernel_launches
    out = torch.empty_like(y)
    n = y.shape[0]
    r = 1 if y.ndim == 1 else y.shape[1]
    if n == 0 or r == 0:
        return out
    index = y.device.index
    vptr = vals.data_ptr()
    if entry is None:
        entry = _bound(n, D, r, y.dtype, index, vptr % 16 == 0)
    fn, words, plan = entry
    args = (vptr, diag.data_ptr(), y.data_ptr(), out.data_ptr(), n, D, d_min,
            r, words, _current_stream(index))
    if index == torch.cuda.current_device():
        err = fn(*args)
    else:
        with torch.cuda.device(index):
            err = fn(*args)
    if err != 0:
        raise RuntimeError("dia kernel launch failed for n=%d D=%d r=%d %s "
                           "with %s: cudaError %d"
                           % (n, D, r, y.dtype, plan, err))
    dia_kernel_launches += 1
    return out


def dia_matvec_cuda(vals, offsets, diag, y):
    """Launch the CUDA kernel: ``(K + diag) y`` on contiguous float32 or
    float64 CUDA tensors; raises on any launch error."""
    _check(vals, diag, y)
    d_min, D = band_range(offsets)
    if D != vals.shape[1]:
        raise ValueError("%d offsets for a value table of %d columns"
                         % (D, vals.shape[1]))
    return _launch(vals, diag, y, d_min, D)


def split_columns(apply, y, width):
    """``apply(y)`` by blocks of at most ``width`` columns (one call when
    ``y`` has no more), the results joined along the columns."""
    if y.ndim == 1 or y.shape[1] <= width:
        return apply(y)
    return torch.cat([apply(y[:, i:i + width].contiguous())
                      for i in range(0, y.shape[1], width)], dim=1)


class DiaOperator(object):
    """``(vals, diag, y) -> (K + diag) y`` for one band structure applied
    many times: ``offsets`` are checked once here, and a call checks only
    what can change between calls (device, dtype, contiguity and shapes, in
    one expression) before it launches the kernel (CUDA tensors) or runs
    the plain version (CPU tensors). A block of more columns than the
    streaming plan takes is launched in blocks of :func:`stream_width`
    columns: the device-memory kernel that would take it whole is about
    5x slower in ``sharded_predict``'s CG on bench_dia's band (H100)."""

    def __init__(self, offsets, n):
        self.offsets = np.asarray(offsets, dtype=np.int64).ravel()
        self.d_min, self.D = band_range(self.offsets)
        self.n = int(n)

    def _width(self, r, dtype):
        """:func:`stream_width` for this band, once per ``(r, dtype)``."""
        cache = self.__dict__.setdefault("_widths", {})
        if (r, dtype) not in cache:
            cache[r, dtype] = stream_width(self.n, self.D, r, dtype)
        return cache[r, dtype]

    def __call__(self, vals, diag, y):
        if y.device.type == "cpu":
            return dia_matvec_plain(vals, self.offsets, diag, y)
        if not (y.is_cuda and vals.device == y.device == diag.device
                and vals.dtype == y.dtype == diag.dtype
                and y.dtype in (torch.float32, torch.float64)
                and y.ndim in (1, 2)
                and vals.shape == (self.n, self.D)
                and diag.shape == (self.n,) and y.shape[0] == self.n
                and vals.is_contiguous() and diag.is_contiguous()
                and y.is_contiguous()):
            _check(vals, diag, y)          # raises with the reason, or
            raise ValueError(              # the shapes are another band's
                "DiaOperator for n=%d, D=%d got vals %s, diag %s, y %s"
                % (self.n, self.D, tuple(vals.shape), tuple(diag.shape),
                   tuple(y.shape)))
        r = 1 if y.ndim == 1 else y.shape[1]
        return split_columns(
            lambda part: _launch(vals, diag, part, self.d_min, self.D), y,
            self._width(r, y.dtype))


def dia_matvec(vals, offsets, diag, y):
    """``(K + diag) y`` for a band: the CUDA kernel on CUDA tensors, the
    plain version on CPU tensors."""
    if y.is_cuda:
        return dia_matvec_cuda(vals.contiguous(), offsets, diag.contiguous(),
                               y.contiguous())
    if y.device.type == "cpu":
        return dia_matvec_plain(vals, offsets, diag, y)
    raise ValueError("no DIA matvec for device %s" % y.device)
