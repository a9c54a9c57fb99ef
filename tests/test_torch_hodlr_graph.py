# -*- coding: utf-8 -*-
"""The CUDA graph of ``HODLRSolver.loglike_fn`` on the card: one value and
gradient captured per compute and replayed after.

Held against the eager sweeps of the same solver (the route refused by
patching ``HODLRSolver._graph_route``): values and gradients at several
thetas in float32 and float64, at rank 12 and at the quasi-periodic
configuration's rank 48; a second ``compute`` on new points captures again
and answers for them; the counters ``graph_replays`` (one a call) and
``graph_captures`` (one a compute) and the leaf kernel's launch count
across a capture and its replays; a replay makes no device read
(``torch.cuda.set_sync_debug_mode("error")``); a capture that raises leaves
the solver eager, with the right answers. The CPU side of the route (the
plumbing, and where it stays eager) is in ``tests/test_torch_hodlr.py``::

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_hodlr_graph.py

This file imports no JAX, so that it runs on the card's machine.
"""

import contextlib

import numpy as np
import pytest
import torch

import george_tpu_torch as gtt
from george_tpu_torch import kernels as tk
from george_tpu_torch.ops import chol as _chol
from george_tpu_torch.solvers import hodlr as TH

torch.set_num_threads(2)

N = 20_000
# float64 graph against eager, (value, gradient): see
# test_graph_matches_eager_float64
GRAPH64 = (1e-9, 1e-5)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _gp(dtype, rank=12, seed=0, qp=False):
    """A HODLR GP on ``N`` sorted points from ``seed``, computed on the
    card, with its ``grad_and_value(log_prob_fn)`` and ``theta0``."""
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0, 200.0, N))
    if qp:
        kernel = 1.0 * tk.ExpSquaredKernel(20.0) * tk.ExpSine2Kernel(
            gamma=1.0, log_period=np.log(3.7))
        y = np.sin(2 * np.pi * x / 3.7) + 0.25 * rng.standard_normal(N)
    else:
        kernel = 1.2 * tk.ExpSquaredKernel(25.0) + 0.3 * tk.Matern32Kernel(
            8.0)
        y = np.sin(0.1 * x) + 0.3 * rng.standard_normal(N)
    gp = gtt.GP(kernel, solver=gtt.HODLRSolver, min_size=128, rank=rank,
                device="cuda", dtype=dtype)
    gp.compute(x, 0.3)
    f = torch.func.grad_and_value(gp.log_prob_fn(x, y, 0.3))
    theta0 = torch.as_tensor(gp.get_parameter_vector(), device="cuda",
                             dtype=dtype)
    return gp, f, theta0


@contextlib.contextmanager
def _eager():
    """The eager sweeps: no call takes the graph's route."""
    route = TH.HODLRSolver._graph_route
    TH.HODLRSolver._graph_route = lambda self, generation, args: False
    try:
        yield
    finally:
        TH.HODLRSolver._graph_route = route


def _thetas(theta0, count, seed=1):
    rng = np.random.default_rng(seed)
    return [theta0 + 0.01 * torch.as_tensor(
        rng.standard_normal(theta0.shape), device=theta0.device,
        dtype=theta0.dtype) for _ in range(count)]


def _gaps(got, want):
    (g, v), (gr, vr) = got, want
    return (float((v - vr).abs() / vr.abs()),
            float((g - gr).abs().max() / gr.abs().max()))


@pytest.mark.cuda
def test_graph_matches_eager_float64():
    """Five thetas through the graph and through the eager sweeps in
    float64. The graph's reverse sweep is plain autograd's, which solves
    with the forward's LU factors where ``torch.func`` factors again:
    rounding only, held to GRAPH64 (value, gradient)."""
    _card()
    gp, f, theta0 = _gp(torch.float64)
    thetas = _thetas(theta0, 5)
    with _eager():
        want = [f(t) for t in thetas]
    got = [f(t) for t in thetas]
    assert gp.solver._graph is not None
    gaps = [_gaps(a, b) for a, b in zip(got, want)]
    print("float64 graph against eager (value, gradient):", gaps)
    for vgap, ggap in gaps:
        assert vgap <= GRAPH64[0] and ggap <= GRAPH64[1], (vgap, ggap)


@pytest.mark.cuda
@pytest.mark.parametrize("rank,qp", [(12, False), (48, True)])
def test_graph_float32_holds_to_float64(rank, qp):
    """Five thetas in float32 through the graph, held to the float64
    eager answer as float32 allows: the value to 1e-5 relative, the
    gradient to 1e-3 of max|g| (a difference of large terms: the float32
    eager sweeps read up to ~3e-4 of max|g| here, the graph as much). At
    rank 48 (the quasi-periodic configuration: cores of 96 x 96) too."""
    _card()
    gp, f, theta0 = _gp(torch.float32, rank=rank, qp=qp)
    _, f64, _ = _gp(torch.float64, rank=rank, qp=qp)
    thetas = _thetas(theta0, 5)
    with _eager():
        truth = [f64(t.double()) for t in thetas]
        want = [f(t) for t in thetas]
    got = [f(t) for t in thetas]
    assert gp.solver._graph is not None
    for a, b, t in zip(got, want, truth):
        t = (t[0].float(), t[1].float())
        (vg, gg), (ve, ge) = _gaps(a, t), _gaps(b, t)
        print("float32 rank %d: graph %.3g %.3g, eager %.3g %.3g from "
              "float64" % (rank, vg, gg, ve, ge))
        assert vg <= 1e-5 and gg <= 1e-3


@pytest.mark.cuda
def test_new_compute_captures_again():
    """A second ``compute`` on new points drops the graph; the next call
    captures one for the new points and answers for them."""
    _card()
    gp, f, theta0 = _gp(torch.float64)
    f(theta0)
    first = gp.solver._graph
    rng = np.random.default_rng(7)
    x = np.sort(rng.uniform(0, 150.0, N))
    y = np.cos(0.2 * x) + 0.3 * rng.standard_normal(N)
    gp.compute(x, 0.3)
    f2 = torch.func.grad_and_value(gp.log_prob_fn(x, y, 0.3))
    captures = TH.graph_captures
    got = f2(theta0)
    assert TH.graph_captures == captures + 1
    assert gp.solver._graph is not None and gp.solver._graph is not first
    with _eager():
        want = f2(theta0)
    vgap, ggap = _gaps(got, want)
    assert vgap <= GRAPH64[0] and ggap <= GRAPH64[1], (vgap, ggap)


@pytest.mark.cuda
def test_counters_move_once_a_call_and_once_a_compute():
    """The route's counters, and the leaf kernel's launch count: the
    warm-up and each replay launch what one eager call does, the capture
    launches nothing."""
    _card()
    captures, replays = TH.graph_captures, TH.graph_replays
    gp, f, theta0 = _gp(torch.float32)
    thetas = _thetas(theta0, 4)
    _chol.chol_kernel_launches = 0
    with _eager():
        f(thetas[0])
    per_call = _chol.chol_kernel_launches
    assert per_call >= 1
    _chol.chol_kernel_launches = 0
    for k, t in enumerate(thetas):
        f(t)
        assert TH.graph_replays == replays + k + 1
        assert TH.graph_captures == captures + 1
        # warm-up, the constructor's checking replay, and k + 1 replays
        assert _chol.chol_kernel_launches == per_call * (k + 3)
    assert gp.solver._graph.launches == per_call
    with torch.no_grad():
        gp.log_prob_fn(gp._x, np.zeros(N), 0.3)(theta0)
    assert TH.graph_replays == replays + 4


@pytest.mark.cuda
def test_replay_reads_nothing_from_the_device():
    """After the capture, a call is copies, a replay and the caller's own
    ops: no synchronizing call."""
    _card()
    _, f, theta0 = _gp(torch.float32)
    f(theta0)
    thetas = _thetas(theta0, 3)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for t in thetas:
            g, v = f(t)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.isfinite(v) and bool(torch.isfinite(g).all())


@pytest.mark.cuda
def test_failed_capture_stays_eager(monkeypatch):
    """A sweep that reads the device cannot be captured: the solver warns,
    counts the capture, answers eagerly and never captures again."""
    _card()
    gp, f, theta0 = _gp(torch.float64)
    thetas = _thetas(theta0, 2)
    with _eager():
        want = [f(t) for t in thetas]
    inv_slogdet = TH._core_inv_slogdet

    def checked(core):
        inv, ld = inv_slogdet(core)
        if not bool(torch.isfinite(ld).all()):     # a device read
            raise ValueError("singular core")
        return inv, ld

    monkeypatch.setattr(TH, "_core_inv_slogdet", checked)
    captures, replays = TH.graph_captures, TH.graph_replays
    with pytest.warns(RuntimeWarning, match="CUDA graph"):
        got = [f(thetas[0])]
    got.append(f(thetas[1]))
    assert gp.solver._graph_refused and gp.solver._graph is None
    assert (TH.graph_captures, TH.graph_replays) == (captures + 1, replays)
    for a, b in zip(got, want):
        vgap, ggap = _gaps(a, b)
        assert vgap <= GRAPH64[0] and ggap <= GRAPH64[1], (vgap, ggap)
