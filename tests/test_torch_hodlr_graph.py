# -*- coding: utf-8 -*-
"""The CUDA graph of ``HODLRSolver.loglike_fn`` on the card: one value and
gradient captured per compute and replayed after.

Held against the eager sweeps of the same solver (the route refused by
patching ``HODLRSolver._graph_route``): values and gradients at several
thetas in float32 and float64, at rank 12 and at the quasi-periodic
configuration's rank 48; a second ``compute`` on new points captures again
and answers for them; the counters ``graph_replays`` (one a call) and
``graph_captures`` (one a compute) and the leaf kernel's launch count
across a capture and its replays; repeated computes and captures on one
GP leave the device memory as they found it; the float64 ACA walk on the
card picks the host walk's pivots; a replay makes no device read
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
def test_recaptures_leave_device_memory_flat():
    """A ``compute`` on new points and a capture after it, four times on
    one GP (a refit as data arrive): the device memory allocated after
    each stays within a quarter of the 64 MiB cuBLAS workspace that a new
    capture stream each time kept (the previous solver's factors and graph
    are more): the allocator's rounding of the blocks each compute reuses
    moves the reading by about 1 MB since the ACA walk runs on the card."""
    _card()
    gp, f, theta0 = _gp(torch.float32)
    f(theta0)
    after = []
    for k in range(4):
        rng = np.random.default_rng(20 + k)
        x = np.sort(rng.uniform(0, 200.0, N))
        y = np.sin(0.1 * x) + 0.3 * rng.standard_normal(N)
        f = None
        gp.compute(x, 0.3)
        f = torch.func.grad_and_value(gp.log_prob_fn(x, y, 0.3))
        f(theta0)
        torch.cuda.synchronize()
        after.append(torch.cuda.memory_allocated())
    assert max(after) - min(after) <= 16 << 20, after


def _first_split_is_a_tie(pair_fn, theta, xa, xb, I, J, I2, J2,
                          rtol=1e-6, atol=1e-10):
    """Whether two ACA walks of one pair (block-local pivots ``I``, ``J``
    and ``I2``, ``J2``) agree until a pick that the kernel does not
    decide. The walk picks ``I[k]`` as the largest entry of the residual
    column ``J[k-1]`` after ``k - 1`` pivots and ``J[k]`` as the largest of
    row ``I[k]`` after ``k``; at the first pick where the walks part, the
    exact residual (the Schur complement of the earlier pivots' block) at
    both picks has to agree to ``rtol`` of itself plus ``atol`` of the
    first pivot, the rounding the walk's downdates carry: two neighbouring
    points on a smooth residual, or noise once a pair of the finest levels
    has reached its numerical rank (5-10 of 12), which any other
    summation order breaks another way."""
    xa, xb = torch.as_tensor(xa), torch.as_tensor(xb)

    def A(r, c):
        return pair_fn(theta, xa[r][:, None, :], xb[c][None, :, :])

    def residual(m, r, c):
        if m == 0:
            return A(r, c)
        return A(r, c) - A(r, J[:m]) @ torch.linalg.solve(A(I[:m], J[:m]),
                                                          A(I[:m], c))

    first = abs(float(A(I[:1], J[:1])))
    for k in range(len(I)):
        if I[k] != I2[k]:
            if k == 0:
                return False    # the walk starts at the last valid row
            a, b = residual(k - 1, np.array([I[k], I2[k]]), J[k - 1:k])
        elif J[k] != J2[k]:
            a, b = residual(k, I[k:k + 1], np.array([J[k], J2[k]]))[0]
        else:
            continue
        a, b = abs(float(a)), abs(float(b))
        return abs(a - b) <= rtol * max(a, b) + atol * first
    return True


@pytest.mark.cuda
@pytest.mark.parametrize("qp", [False, True], ids=["smooth", "qp"])
def test_device_aca_walk_picks_the_host_pivots(qp):
    """``compute`` on the card walks ACA there, in float64: in every pair
    of every level its row and column pivots are the host walk's up to a
    pick the kernel does not decide (:func:`_first_split_is_a_tie`), and
    the coarse levels, whose pairs stay above rounding, agree in all."""
    _card()
    gp, _, _ = _gp(torch.float32, rank=48 if qp else 12, qp=qp)
    sol = gp.solver
    st = sol._struct
    xs = sol._x[sol._perm]
    xpad = np.concatenate([xs, np.repeat(xs[-1:], st.n_pad - st.n, axis=0)])
    valid = np.arange(st.n_pad) < st.n
    host = TH.build_structure(st.n, min_size=sol.min_size, rank=sol.rank,
                              seed=sol.seed, x_sorted=xs)
    theta = torch.as_tensor(gp.kernel.parameter_vector, dtype=torch.float64)
    TH.select_aca_pivots(gp.kernel.pair_fn, theta, xpad, valid, host)
    for li, (mine, want) in enumerate(zip(st.levels, host.levels)):
        s = want["s"]
        if li < 2:
            assert np.array_equal(mine["row_piv"], want["row_piv"])
            assert np.array_equal(mine["col_piv"], want["col_piv"])
        for q in range(want["p"]):
            blk = xpad[2 * q * s:2 * (q + 1) * s]
            local = [piv[q] - 2 * q * s - h for piv, h in (
                (want["row_piv"], 0), (want["col_piv"], s),
                (mine["row_piv"], 0), (mine["col_piv"], s))]
            assert _first_split_is_a_tie(gp.kernel.pair_fn, theta, blk[:s],
                                         blk[s:], *local), (s, q)


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
