# -*- coding: utf-8 -*-
"""One step of Jacobi-preconditioned conjugate gradients on a block of
right-hand sides, for the sparse solver's ``cg_solve``.

A step takes the CG state after the apply ``AP = (K + diag) P``: the
``(n, r)`` blocks ``X``, ``R``, ``P`` and ``AP``, ``minv = 1 /`` the
Jacobi preconditioner ``(n,)``, the per-column ``rz`` and ``b2`` ``(r,)``
and ``state``, the int32 pair ``[done, it]`` on the device, and does

    denom = sum P * AP;   alpha = rz / (denom > 0 ? denom : 1)
    X += alpha P;  R -= alpha AP;  Z = minv R
    rz' = sum R * Z;      P = Z + (rz' / (rz > 0 ? rz : 1)) P;  rz = rz'
    it += 1;  done = it >= maxiter or no column has sum R * R / b2 > tol2

unless it finds ``done`` set, when it writes nothing: the host may read
``state`` only every few steps and launch steps past the stop, which are
wasted work and never a different answer. In these pieces:

* :func:`cg_step_cuda` launches the hand-written CUDA kernel
  (``csrc/cg.cu``) on CUDA tensors, in place, after checking everything
  about them, and counts the launch in :data:`cg_device_steps`;
* :func:`cg_step_plain` is the same step in torch ops, the loop body of
  ``solvers/sparse.py::pcg_solve`` in its order, each update kept only
  where ``done`` is clear: it serves CPU tensors and is the yardstick the
  kernel is held against on the card;
* :func:`cg_step` dispatches on the tensors' device (CUDA tensors take the
  kernel or raise); :func:`cg_workspace` checks a solve's CUDA tensors and
  makes the kernel's scratch, once per solve.

Kernel note. Replaces no Pallas kernel: the JAX package runs this loop
body inside ``lax.while_loop`` (``george_tpu/solvers/sparse.py``), where
XLA fuses the updates and reductions and the stopping test never leaves
the device; eager torch ran it as some twenty kernels a step. What bounds
it on the card is device memory: a step reads ``P``, ``AP``, ``X``, ``R``
and ``minv`` and writes ``X``, ``R`` and ``P`` at the least (6.4 MB at n =
2e5, r = 1, float32; 90 MB at r = 16). The design is one cooperative
launch a step, its three passes (``P . AP``; the updates and ``R . Z``,
``R . R``; ``P``) separated by grid barriers, each block owning whole rows
and its threads fixed columns, the column sums reduced in float64 in a
fixed order so that every block and every run gets the same bits. See
``csrc/cg.cu``; ``chip_smoke.py`` holds it to :func:`cg_step_plain` and
times both on the card.
"""

import ctypes
import functools

import torch

from .dia import _current_stream

__all__ = ["cg_step", "cg_step_plain", "cg_step_cuda", "cg_workspace"]

# launches of the CUDA step in this process, stopped steps included (read
# and reset it as ``george_tpu_torch.ops.cg.cg_device_steps``)
cg_device_steps = 0


def cg_step_plain(X, R, P, AP, minv, rz, b2, state, tol2, maxiter):
    """One CG step in torch ops (see the module's docstring); returns the
    new ``(X, R, P, rz, state)``."""
    go = state[0] == 0
    denom = torch.sum(P * AP, dim=0)
    alpha = rz / torch.where(denom > 0, denom, 1.0)
    X_new = X + alpha * P
    R_new = R - alpha * AP
    Z = minv[:, None] * R_new
    rz_new = torch.sum(R_new * Z, dim=0)
    P_new = Z + (rz_new / torch.where(rz > 0, rz, 1.0)) * P
    it = state[1] + 1
    stop = (it >= maxiter) | ~torch.any(
        torch.sum(R_new * R_new, dim=0) / b2 > tol2)
    state_new = torch.stack([stop.to(state.dtype), it])
    return (torch.where(go, X_new, X), torch.where(go, R_new, R),
            torch.where(go, P_new, P), torch.where(go, rz_new, rz),
            torch.where(go, state_new, state))


# ---------------------------------------------------------------------------
# the launch
# ---------------------------------------------------------------------------

def _bind(n, r, dtype, index):
    """The C function and the launch geometry ``(grid, shared bytes)`` of
    one shape on device ``index``."""
    from ._build import load

    lib = load()
    out = (ctypes.c_int * 2)()
    with torch.cuda.device(index):
        err = lib.george_cg_plan(dtype.itemsize, n, r, out)
    if err != 0:
        raise RuntimeError("cg step plan failed for n=%d r=%d %s on cuda:%d: "
                           "cudaError %d" % (n, r, dtype, index, err))
    fn = (lib.george_cg_step_f32 if dtype == torch.float32
          else lib.george_cg_step_f64)
    return fn, out[0], out[1]


# each launch shape is planned once per process
_bound = functools.lru_cache(maxsize=256)(_bind)


def _check(X, **named):
    """Raise, with the reason, unless ``X`` and the ``named`` tensors
    (``R``, ``P``, ``AP``, ``minv``, ``rz``, ``b2``, ``state``) are what
    the kernel takes: contiguous CUDA tensors on ``X``'s device, ``X``
    ``(n, r)`` with n, r > 0 in float32 or float64, ``R``, ``P``, ``AP``
    ``(n, r)``, ``minv`` ``(n,)``, ``rz`` and ``b2`` ``(r,)`` in ``X``'s
    dtype, ``state`` the int32 pair."""
    if X.dtype not in (torch.float32, torch.float64):
        raise TypeError("cg_step_cuda takes float32 or float64, got %s"
                        % X.dtype)
    if X.ndim != 2 or X.shape[0] == 0 or X.shape[1] == 0:
        raise ValueError("cg_step_cuda takes X (n, r) with n, r > 0, got %s"
                         % (tuple(X.shape),))
    n, r = X.shape
    shapes = {"X": (n, r), "R": (n, r), "P": (n, r), "AP": (n, r),
              "minv": (n,), "rz": (r,), "b2": (r,), "state": (2,)}
    for name, t in (("X", X),) + tuple(named.items()):
        if not t.is_cuda:
            raise ValueError("cg_step_cuda needs CUDA tensors, %s is on %s"
                             % (name, t.device))
        if t.device != X.device:
            raise ValueError("cg_step_cuda: %s is on %s, X on %s"
                             % (name, t.device, X.device))
        if not t.is_contiguous():
            raise ValueError("cg_step_cuda takes contiguous tensors; %s is "
                             "not" % name)
        dtype = torch.int32 if name == "state" else X.dtype
        if t.dtype != dtype:
            raise TypeError("cg_step_cuda: %s is %s, not %s"
                            % (name, t.dtype, dtype))
        if tuple(t.shape) != shapes[name]:
            raise ValueError("cg_step_cuda: %s is %s, not %s with X %s"
                             % (name, tuple(t.shape), shapes[name],
                                tuple(X.shape)))


def cg_workspace(X, R, P, minv, rz, b2, state):
    """Check the CUDA tensors of one solve against what the kernel takes
    (raising with the reason) and make its scratch for them: zeroed, its
    first word the grid barrier. They keep their shapes through a solve,
    so the steps that take this scratch check only the new ``AP``."""
    _check(X, R=R, P=P, minv=minv, rz=rz, b2=b2, state=state)
    n, r = X.shape
    _, grid, _ = _bound(n, r, X.dtype, X.device.index)
    return torch.zeros(1 + 3 * grid * r, dtype=torch.float64,
                       device=X.device)


def cg_step_cuda(X, R, P, AP, minv, rz, b2, state, tol2, maxiter,
                 work=None):
    """Launch the CUDA kernel: one CG step on contiguous float32 or
    float64 CUDA tensors, in place in ``X``, ``R``, ``P``, ``rz`` and
    ``state``, which it returns. ``work`` is what :func:`cg_workspace`
    returned for these tensors, which it checked; without it they are
    checked and the scratch is made here. ``AP`` is checked at every call;
    raises on any launch error."""
    global cg_device_steps
    _check(X, AP=AP)
    if work is None:
        work = cg_workspace(X, R, P, minv, rz, b2, state)
    n, r = X.shape
    index = X.device.index
    fn, grid, smem = _bound(n, r, X.dtype, index)
    if not (work.device == X.device and work.dtype == torch.float64
            and work.numel() == 1 + 3 * grid * r):
        raise ValueError("cg_step_cuda: the workspace is not cg_workspace's "
                         "for X of %s %s" % (tuple(X.shape), X.dtype))
    args = (X.data_ptr(), R.data_ptr(), P.data_ptr(), AP.data_ptr(),
            minv.data_ptr(), rz.data_ptr(), b2.data_ptr(), state.data_ptr(),
            work.data_ptr(), n, r, float(tol2), int(maxiter), grid, smem,
            _current_stream(index))
    if index == torch.cuda.current_device():
        err = fn(*args)
    else:
        with torch.cuda.device(index):
            err = fn(*args)
    if err != 0:
        raise RuntimeError("cg step launch failed for n=%d r=%d %s (grid %d, "
                           "%d shared bytes): cudaError %d"
                           % (n, r, X.dtype, grid, smem, err))
    cg_device_steps += 1
    return X, R, P, rz, state


def cg_step(X, R, P, AP, minv, rz, b2, state, tol2, maxiter, work=None):
    """One CG step: the CUDA kernel on CUDA tensors (in place), the plain
    version on CPU tensors; returns ``(X, R, P, rz, state)``."""
    if X.is_cuda:
        return cg_step_cuda(X, R, P, AP, minv, rz, b2, state, tol2, maxiter,
                            work)
    if X.device.type == "cpu":
        return cg_step_plain(X, R, P, AP, minv, rz, b2, state, tol2,
                             maxiter)
    raise ValueError("no CG step for device %s" % X.device)
