# -*- coding: utf-8 -*-
"""The port's CG step (``ops/cg.py``): the CUDA kernel held against its
plain version, and the checks around it.

On the CPU: the wrapper refuses what the kernel does not take before it
builds or launches, the dispatcher takes the plain version for CPU tensors
without building anything, and a plain step that finds ``done`` set
changes nothing. The kernel itself runs only on a card (the tests marked
``cuda``), at the sparse cell's shapes (n = 2e5, r = 1 and 16, float32),
on a ragged column count and in float64, and in a whole ``cg_solve``
through the solver's DIA apply against the CPU's float64 loop::

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cg.py

This file imports no JAX, so that it runs on the card's machine.
"""

import numpy as np
import pytest
import torch

from george_tpu_torch.ops import _build
from george_tpu_torch.ops import cg as tcg

torch.set_num_threads(2)


def _state(rng, n, r, dtype, device="cpu", done=0, it=3):
    """A CG state as the solver holds it after a few steps: positive
    ``minv``, ``rz`` and ``b2``; ``AP`` a symmetric positive-definite
    tridiagonal operator applied to ``P``."""
    def t(a):
        return torch.as_tensor(a).to(device, dtype).contiguous()

    X = rng.standard_normal((n, r))
    R = rng.standard_normal((n, r))
    P = rng.standard_normal((n, r))
    AP = 2.5 * P
    AP[1:] -= P[:-1]
    AP[:-1] -= P[1:]
    minv = rng.uniform(0.5, 2.0, n)
    rz = np.sum(R * (minv[:, None] * R), axis=0)
    b2 = np.sum(R * R, axis=0) * rng.uniform(1.0, 4.0, r)
    state = torch.tensor([done, it], dtype=torch.int32, device=device)
    return [t(X), t(R), t(P), t(AP), t(minv), t(rz), t(b2), state]


def _bad_args(bad, device):
    """A small step's arguments with one fault."""
    args = _state(np.random.default_rng(0), 8, 2, torch.float32, device)
    if bad == "cpu":
        args[3] = args[3].cpu()
    elif bad == "dtype":
        args = [a.half() if a.is_floating_point() else a for a in args]
    elif bad == "shape":
        args[4] = args[4][:7]
    elif bad == "mixed":
        args[1] = args[1].double()
    elif bad == "state":
        args[7] = args[7].long()
    elif bad == "strided":
        args[2] = torch.zeros(2, 8, device=device).mT
    return args


BAD = ["cpu", "dtype", "shape", "mixed", "state", "strided"]


@pytest.mark.parametrize("bad", BAD)
def test_cuda_wrapper_refuses_before_launch(bad, monkeypatch):
    """``cg_step_cuda`` checks its inputs before it builds or launches."""
    def refuse():
        raise AssertionError("a refused step must not build the kernels")

    monkeypatch.setattr(_build, "build", refuse)
    monkeypatch.setattr(_build, "load", refuse)
    with pytest.raises((ValueError, TypeError)):
        tcg.cg_step_cuda(*_bad_args(bad, "cpu"), 1e-6, 100)


def test_cpu_tensors_take_the_plain_step(monkeypatch):
    """The dispatcher runs the plain version on CPU tensors: no build, no
    workspace, no count; a step that finds ``done`` set changes nothing,
    one that finds it clear counts one iteration."""
    def refuse():
        raise AssertionError("the CPU path must not build the kernels")

    monkeypatch.setattr(_build, "build", refuse)
    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(tcg, "cg_device_steps", 0)
    rng = np.random.default_rng(1)
    args = _state(rng, 50, 3, torch.float64)
    with pytest.raises(ValueError):
        tcg.cg_workspace(*args[:3], *args[4:])
    out = tcg.cg_step(*args, 1e-6, 100)
    ref = tcg.cg_step_plain(*args, 1e-6, 100)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    assert out[4].tolist() == [0, 4]
    assert not torch.equal(out[0], args[0])
    stopped = _state(rng, 50, 3, torch.float64, done=1, it=7)
    out = tcg.cg_step(*stopped, 1e-6, 100)
    assert all(torch.equal(a, b) for a, b in zip(out, [
        stopped[0], stopped[1], stopped[2], stopped[5], stopped[7]]))
    assert tcg.cg_device_steps == 0


def test_plain_step_stops_at_the_cap_and_the_tolerance():
    """``done`` is set by the step that reaches ``maxiter``, or whose
    residuals all meet the tolerance, and not otherwise."""
    args = _state(np.random.default_rng(2), 50, 3, torch.float64, it=4)
    assert tcg.cg_step_plain(*args, 1e-12, 6)[4].tolist() == [0, 5]
    assert tcg.cg_step_plain(*args, 1e-12, 5)[4].tolist() == [1, 5]
    assert tcg.cg_step_plain(*args, 1e6, 100)[4].tolist() == [1, 5]


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("n,r,dtype", [
    (200_000, 1, torch.float32),
    (200_000, 16, torch.float32),
    (200_037, 17, torch.float32),
    (5000, 1, torch.float64),
    (5000, 3, torch.float64),
    (3000, 1100, torch.float32)])
def test_cuda_step_matches_plain(n, r, dtype):
    """One kernel step against the plain step on the same inputs on the
    card: the sparse cell's shapes (r = 1 for the value's solve and its
    adjoint, r = 16 for the probe solve), a ragged column count, float64,
    and more columns than a block has threads (two column chunks). The
    sums differ only in their order (float64 partials against torch's
    reductions in the working type): 1e-4 of each vector's largest entry
    in float32, 1e-11 in float64; the flag and count are equal."""
    _needs_card()
    rng = np.random.default_rng(4)
    args = _state(rng, n, r, dtype, device="cuda")
    tol = 1e-4 if dtype == torch.float32 else 1e-11
    ref = tcg.cg_step_plain(*args, 1e-3, 100)
    before = tcg.cg_device_steps
    run = [a.clone() for a in args]
    work = tcg.cg_workspace(*run[:3], *run[4:])
    out = tcg.cg_step_cuda(*run, 1e-3, 100, work)
    torch.cuda.synchronize()
    assert tcg.cg_device_steps == before + 1
    for name, a, b in zip(("X", "R", "P", "rz"), out[:4], ref[:4]):
        err = float((a - b).abs().max())
        assert err <= tol * float(b.abs().max()), (name, err)
    assert out[4].tolist() == ref[4].tolist() == [0, 4]
    # the workspace serves the next step: its barrier word is back at zero
    out2 = tcg.cg_step_cuda(*out[:3], args[3], args[4], out[3], args[6],
                            out[4], 1e-3, 100, work)
    torch.cuda.synchronize()
    assert out2[4].tolist() == [0, 5]


@pytest.mark.cuda
def test_cuda_plans_in_any_order():
    """A shape planned after a wider one leaves the wider one launchable:
    planning r = 1 after r = 1100 must not lower the kernel's shared-memory
    limit below what the r = 1100 launches ask for. The narrow shape's n
    is used by no other test, so its plan runs here, after the wide one."""
    _needs_card()
    rng = np.random.default_rng(7)
    wide = _state(rng, 3000, 1100, torch.float32, device="cuda")
    ref = tcg.cg_step_plain(*wide, 1e-3, 100)
    run = [a.clone() for a in wide]
    work = tcg.cg_workspace(*run[:3], *run[4:])
    narrow = _state(rng, 4099, 1, torch.float32, device="cuda")
    tcg.cg_step_cuda(*narrow, 1e-3, 100)
    out = tcg.cg_step_cuda(*run, 1e-3, 100, work)
    torch.cuda.synchronize()
    for name, a, b in zip(("X", "R", "P", "rz"), out[:4], ref[:4]):
        err = float((a - b).abs().max())
        assert err <= 1e-4 * float(b.abs().max()), (name, err)
    assert out[4].tolist() == [0, 4]


@pytest.mark.cuda
def test_cuda_stopped_step_writes_nothing():
    """A kernel step that finds ``done`` set leaves every tensor as it was,
    bit for bit, and still counts as a launch."""
    _needs_card()
    args = _state(np.random.default_rng(5), 200_000, 16, torch.float32,
                  device="cuda", done=1, it=9)
    keep = [a.clone() for a in args]
    before = tcg.cg_device_steps
    tcg.cg_step_cuda(*args, 1e-3, 100)
    torch.cuda.synchronize()
    assert tcg.cg_device_steps == before + 1
    assert all(torch.equal(a, b) for a, b in zip(args, keep))


@pytest.mark.cuda
@pytest.mark.parametrize("bad", BAD + ["workspace"])
def test_cuda_wrapper_refuses_bad_cuda_inputs(bad):
    """On the card too, each fault is refused before a launch: a tensor
    left on the CPU, a half dtype, a wrong shape, mixed dtypes, a state
    that is not int32, a strided block, another shape's workspace."""
    _needs_card()
    work = None
    if bad == "workspace":
        args = _state(np.random.default_rng(0), 8, 2, torch.float32, "cuda")
        work = torch.zeros(2, dtype=torch.float64, device="cuda")
    else:
        args = _bad_args(bad, "cuda")
    before = tcg.cg_device_steps
    with pytest.raises((ValueError, TypeError)):
        tcg.cg_step_cuda(*args, 1e-6, 100, work)
    assert tcg.cg_device_steps == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_cg_solve_matches_the_cpu_loop(dtype):
    """A whole ``cg_solve`` on the card (the DIA apply and the kernel step)
    against the CPU's float64 loop, on the sparse cell's kind of band
    (sorted 1-D points at its density, a Wendland-tapered squared
    exponential, its noise, n = 20,000, two columns) at the solver's
    tolerance for the dtype (1e-10, floored at 30 eps). In float64 the
    solutions agree to 1e-7 relative and the iteration counts within 2%.
    In float32 the recurrence's residual drifts from the true one (the
    card's answer leaves a true residual of about 5e-3 of ``b``, measured
    on an H100), so the kernel's loop is held to the per-iteration loop
    of torch ops on the card in the same precision: its distance from the
    float64 answer is at most twice that loop's. The card ran one step
    for every iteration up to the next read of the stopping test."""
    _needs_card()
    import george_tpu_torch as tgt
    from george_tpu_torch.solvers import sparse as TS

    rng = np.random.default_rng(6)
    n = 20_000
    x = np.sort(rng.uniform(0, n / 50.0, n))
    kernel = tgt.kernels.WendlandC2Kernel(
        log_rc=np.log(2.0), kernel_base=tgt.kernels.ExpSquaredKernel(1.0))
    b = rng.standard_normal((n, 2))
    out, solvers = {}, {}
    for device, dt in (("cpu", torch.float64), ("cuda", dtype)):
        s = solvers[device] = tgt.SparseSolver(
            kernel, direct=False, device=device, dtype=dt)
        s.compute(x[:, None], 0.1)
        before = tcg.cg_device_steps
        X, it = TS.cg_solve(s._apply_fixed, s._tensor(b), s._pdiag,
                            tol=s._eff_tol, maxiter=1000)
        out[device] = (X.double().cpu().numpy(), it,
                       tcg.cg_device_steps - before)
    (xc, itc, stepc), (xg, itg, stepg) = out["cpu"], out["cuda"]
    assert stepc == 0 and 0 < itc < 1000 and 0 < itg < 1000
    assert stepg == -(-itg // TS.CG_READ_EVERY) * TS.CG_READ_EVERY
    rel = np.linalg.norm(xg - xc) / np.linalg.norm(xc)
    if dtype == torch.float64:
        assert rel <= 1e-7, rel
        assert abs(itg - itc) <= 0.02 * itc, (itg, itc)
    else:
        s = solvers["cuda"]
        Minv = (1.0 / s._pdiag)[:, None]
        xp, _ = TS.pcg_solve(s._apply_fixed, lambda R: Minv * R,
                             s._tensor(b), tol=s._eff_tol, maxiter=1000)
        rel_plain = (np.linalg.norm(xp.double().cpu().numpy() - xc)
                     / np.linalg.norm(xc))
        assert rel <= 2.0 * rel_plain, (rel, rel_plain)
