# -*- coding: utf-8 -*-
"""Smoke run of the PyTorch/CUDA port (``george_tpu_torch``) on one GPU.

Drives the port's two paths once through their public entry points, at the
sizes the project benchmarks:

* the HODLR marginal log-likelihood and its gradient at n = 1e5 on the
  smooth 1-D dataset (ExpSquared + Matern32, skeleton rank 12, ``min_size``
  128: 9 levels, 512 leaf boxes of 196 points);
* the compact-support sparse solver on the dataset of
  ``benchmarks/bench_dia.py``: n = 2e5 sorted points on [0, n/50], a
  ``WendlandC2Kernel`` (cutoff 2) over ``ExpSquaredKernel(metric=1)``,
  yerr 0.1, seed 0: about 200 neighbours per point, a band of about 301
  diagonals.

Phases:

1. device: require CUDA, print the card, its power limit and the versions;
2. build: compile the hand-written CUDA kernels from ``csrc/`` (one
   ``nvcc`` per source, all at once);
3. kernels, each against its plain torch version on the card, with its
   time beside the plain version's, a library call's and the card's bound:
   the leaf Cholesky (both variants), the DIA matvec (f32 r = 1, 16, 17
   and 40 and f64 r = 4 on the bench_dia value table, a ragged n, the
   device-memory variant) and the tiled Cholesky (shared and device memory, a
   near-singular batch);
4. HODLR slice, float32: ``GP.compute`` + ``log_likelihood`` and the
   Hutchinson likelihood + gradient, both against the float64 truth anchor,
   the time per evaluation and the leaf kernel's launch count; then, outside
   that count, a per-stage breakdown and a ``torch.profiler`` window;
5. HODLR slice, float64: the likelihood against the anchor, and the exact
   autograd gradient against central finite differences;
6. sparse slice, direct (exact banded Cholesky), float64 then float32: the
   float64 numbers are the exact reference of phase 7;
7. sparse slice, iterative (``direct=False``), float32: CG + SLQ +
   Hutchinson through the DIA kernel, each piece against its own bound,
   the DIA kernel's launch count, timings and a ``torch.profiler`` window
   over one gradient;
8. a 2-D sparse check (the gather path, no band) at n = 2e4, float32.

Any failed check raises, and the script exits nonzero without printing its
last line, ``{"ok": true, "device": {...}}``. Run it from the repository
root with no arguments::

    python3 chip_smoke.py

It imports nothing of JAX or of the JAX package.
"""

import json
import os
import re
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# bench.py's float64 truth anchor for the smooth dataset at n = 1e5: a
# rank-96 float64 HODLR factorization; rank 12 sits ~3e-8 from it
ANCHOR = -23484.7706
ANCHOR_F32 = 2e-3
ANCHOR_F64 = 1e-6
N_MAIN = 100_000
N_DIA = 200_000

# the card's published peaks (H100 SXM data sheet, at 700 W): device memory
# bytes/s and float32 / float64 non-tensor FLOP/s
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}


def log(msg):
    print(msg, flush=True)


def smooth_dataset(n):
    """bench.py's smooth dataset, same numpy stream: x, y, yerr, kernel."""
    from george_tpu_torch import kernels

    rng = np.random.default_rng(42)
    x = np.sort(rng.uniform(0, 1000.0, n))[:, None]
    y = np.sin(0.1 * x[:, 0]) + 0.3 * rng.standard_normal(n)
    yerr = np.sqrt(0.09) * np.ones(n)
    kernel = 1.2 * kernels.ExpSquaredKernel(25.0) + 0.3 * (
        kernels.Matern32Kernel(8.0))
    return x, y, yerr, kernel


def check_anchor(name, ll, rel_tol, n):
    if not np.isfinite(ll):
        raise RuntimeError("%s: non-finite log-likelihood %r" % (name, ll))
    if n != N_MAIN:
        log("%s: ll %.10f (no anchor at n=%d)" % (name, ll, n))
        return None
    rel = abs(ll - ANCHOR) / abs(ANCHOR)
    log("%s: ll %.10f, anchor %.4f, rel err %.3e (limit %.0e)"
        % (name, ll, ANCHOR, rel, rel_tol))
    if rel > rel_tol:
        raise RuntimeError("%s: %.3e off the anchor (limit %.0e)"
                           % (name, rel, rel_tol))
    return rel


def sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def bound(nbytes, flops, dtype):
    """The least time the card could take, in ms, and what bounds it."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FLOPS[str(dtype).split(".")[-1]] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def chol_bytes(B, m, itemsize):
    """Bytes a batched lower Cholesky must move: the lower triangle of
    each ``(m, m)`` block read, all of its factor written."""
    return B * (m * (m + 1) // 2 + m * m) * itemsize


def rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return np.abs(a - b) / np.abs(b)


def cuda_ms(fn, warmup=3, runs=21):
    """Median milliseconds of ``fn()`` on the card, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return float(np.median(times))


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available()"
                         " is False); this script runs only on a GPU")
    import george_tpu_torch

    pkg = os.path.dirname(os.path.abspath(george_tpu_torch.__file__))
    if os.path.dirname(pkg) != HERE:
        raise SystemExit("chip_smoke: george_tpu_torch was imported from %s,"
                         " not from this checkout" % pkg)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log("device: %s | torch %s | CUDA %s | python %s"
        % (torch.cuda.get_device_name(0), torch.__version__,
           torch.version.cuda, sys.version.split()[0]))
    return smi


def phase_build():
    from george_tpu_torch.ops import _build

    t0 = time.perf_counter()
    path = _build.build()
    compiler_log = _build.build_info.get("log", "")
    _build.load()
    seconds = time.perf_counter() - t0
    log("build: %.2f s -> %s" % (seconds, os.path.relpath(path, HERE)))
    # ptxas -v: one "Compiling entry function" line per kernel, then its
    # spills and its registers; print the range, and any kernel that spills
    regs, name = {}, None
    for line in compiler_log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "Used" in line and "registers" in line and name:
            regs[name] = int(line.split("Used")[1].split()[0])
        elif "spill" in line and name and any(
                int(v) for v in re.findall(r"(\d+) bytes spill", line)):
            log("  ptxas spills: %s %s" % (name, line.strip()))
    if regs:
        log("  ptxas: %d kernels, %d-%d registers"
            % (len(regs), min(regs.values()), max(regs.values())))
    return seconds


def _spd(B, m, dtype, jitter=1.0, seed=0):
    """Random SPD blocks on the card (the recipe of tests/test_ops.py)."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    X = torch.randn((B, m, 3 * m), generator=g, device="cuda",
                    dtype=torch.float64)
    A = X @ X.mT / (3 * m) + jitter * torch.eye(m, device="cuda",
                                                dtype=torch.float64)
    return A.to(dtype).contiguous()


def phase_kernel():
    import torch
    from george_tpu_torch.ops import chol

    out = {}
    cases = [(512, 196, torch.float32, True, 1e-4),
             (64, 489, torch.float32, False, 1e-4),
             (16, 196, torch.float64, False, 1e-10)]
    for B, m, dtype, smem, tol in cases:
        uses = chol.uses_shared_memory(m, dtype)
        if uses != smem:
            raise RuntimeError("(%d, %s) takes the %s variant, expected %s"
                               % (m, dtype, uses, smem))
        A = _spd(B, m, dtype)
        before = chol.chol_kernel_launches
        L = chol.cholesky_cuda(A)
        torch.cuda.synchronize()
        if chol.chol_kernel_launches != before + 1:
            raise RuntimeError("launch counter did not rise")
        L_ref = chol.cholesky_plain(A)
        torch.cuda.synchronize()
        err = float((L - L_ref).abs().max())
        scale = float(L_ref.abs().max())
        upper = bool((torch.triu(L, 1) == 0).all())
        log("kernel (%d, %d) %s [%s]: max|dL| %.3e = %.3e max|L| "
            "(limit %.0e), upper zero %s"
            % (B, m, str(dtype).split(".")[-1],
               "shared" if smem else "device", err, err / scale, tol,
               upper))
        if not (err <= tol * scale and upper and bool(torch.isfinite(L).all())):
            raise RuntimeError("kernel disagrees with plain at (%d, %d) %s"
                               % (B, m, dtype))
        if (B, m, dtype) == (512, 196, torch.float32):
            out["max_abs_err"] = err
    A = _spd(4, 128, torch.float32, jitter=1e-4, seed=5)
    L = chol.cholesky_cuda(A)
    torch.cuda.synchronize()
    rec = float((L @ L.mT - A).abs().max())
    log("kernel near-singular (4, 128) f32: finite %s, max|LL^T - A| %.3e"
        % (bool(torch.isfinite(L).all()), rec))
    if not (bool(torch.isfinite(L).all()) and rec <= 5e-4):
        raise RuntimeError("near-singular batch failed")

    A = _spd(512, 196, torch.float32)
    out["ms"] = cuda_ms(lambda: chol.cholesky_cuda(A))
    out["plain_ms"] = cuda_ms(lambda: chol.cholesky_plain(A))
    out["cusolver_ms"] = cuda_ms(lambda: torch.linalg.cholesky(A))
    out["library_ms"] = out["cusolver_ms"]
    out["bound_ms"], out["bound_by"] = bound(chol_bytes(512, 196, 4),
                                             512 * 196 ** 3 / 3.0, A.dtype)
    log("kernel time (512, 196) f32, median of 21: kernel %.4f ms, plain "
        "%.4f ms, torch.linalg.cholesky %.4f ms, bound %.4f ms (%s)"
        % (out["ms"], out["plain_ms"], out["cusolver_ms"], out["bound_ms"],
           out["bound_by"]))
    return out


def _hutchinson_args(gp, y):
    """The solver's device tensors and the padded residual, in its order."""
    import torch

    s = gp.solver
    st = s._struct
    r = np.zeros(st.n_pad)
    r[:st.n] = y[s._perm]
    return (gp.kernel.pair_fn, s._theta, s._xpad, s._valid, s._diag_pad,
            torch.as_tensor(r, device=s.device, dtype=s.dtype), st)


def phase_slice_f32(device, n):
    import torch
    import george_tpu_torch as gtt
    from george_tpu_torch.solvers import hodlr as H

    x, y, yerr, kernel = smooth_dataset(n)
    out = {}
    gp = gtt.GP(kernel, solver=gtt.HODLRSolver, min_size=128, rank=12,
                device=device, dtype=torch.float32)
    t0 = time.perf_counter()
    gp.compute(x, yerr)
    ll = gp.log_likelihood(y)
    sync(device)
    st = gp.solver._struct
    log("slice f32: n=%d L=%d leaves %d x %d, compute + log_likelihood "
        "%.3f s" % (n, st.L, st.n_pad // st.m, st.m,
                    time.perf_counter() - t0))
    out["gp_rel"] = check_anchor("slice f32 GP.log_likelihood", ll,
                                 ANCHOR_F32, n)

    pair, theta, xpad, valid, diag, r, st = _hutchinson_args(gp, y)
    gen = torch.Generator(device=device).manual_seed(0)

    def evaluate(th):
        return H.hodlr_loglike_and_grad_hutchinson(
            pair, th, xpad, valid, diag, r, st, generator=gen,
            num_probes=8, n_real=n, refine_steps=1)

    ll_h, g_h = evaluate(theta)
    sync(device)
    g_h = g_h.cpu().numpy()
    out["hutch_rel"] = check_anchor("slice f32 Hutchinson", float(ll_h),
                                    ANCHOR_F32, n)
    log("slice f32 Hutchinson gradient: %s" % np.array2string(g_h))
    if not np.all(np.isfinite(g_h)):
        raise RuntimeError("non-finite Hutchinson gradient")

    # bench.py's protocol: 16 distinct thetas queued, one sync, best of 3
    thetas = [theta + 1e-5 * k for k in range(16)]
    times = []
    for _ in range(3):
        sync(device)
        t0 = time.perf_counter()
        outs = [evaluate(th) for th in thetas]
        sync(device)
        times.append((time.perf_counter() - t0) / len(thetas) * 1e3)
        if not all(bool(torch.isfinite(o[0])) for o in outs):
            raise RuntimeError("non-finite log-likelihood in the timed run")
    out["ms_per_eval"] = min(times)
    out["ms_per_eval_all"] = times
    log("slice f32 Hutchinson ll+grad: %.3f ms/eval (best of 3 x 16; all "
        "%s)" % (min(times), ", ".join("%.3f" % t for t in times)))
    return out, evaluate, thetas, (pair, theta, xpad, valid, diag, r, st)


def stage_breakdown(pair, theta, xpad, valid, diag, r, st, device):
    """Milliseconds of each stage of one Hutchinson evaluation, each run
    alone between synchronizations (median of 5)."""
    import torch
    from george_tpu_torch.solvers import hodlr as H

    def timed(fn):
        fn()
        ts = []
        for _ in range(5):
            sync(device)
            t0 = time.perf_counter()
            fn()
            sync(device)
            ts.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(ts))

    B, m = st.n_pad // st.m, st.m
    xb, vb = xpad.reshape(B, m, -1), valid.reshape(B, m)
    db = diag.reshape(B, m)
    with torch.no_grad():
        factors, _ = H.hodlr_factor(pair, theta, xpad, valid, diag, st)
        rhs = torch.randn((9, st.n_pad), device=device, dtype=diag.dtype)
        stages = {
            "leaf_assemble_chol": timed(
                lambda: H._leaf_cholesky(pair, theta, xb, vb, db)),
            "skeletons": timed(
                lambda: H._all_lowrank_t(pair, theta, xpad, valid, st)),
            "factor_total": timed(
                lambda: H.hodlr_factor(pair, theta, xpad, valid, diag, st)),
            "solve_9rhs": timed(lambda: H._solve_t(factors, st, rhs)),
            "matvec_factors_9rhs": timed(
                lambda: H._matvec_factors_t(factors, st, rhs)),
        }

    stages["grad_jvp_pass"] = timed(
        lambda: H.dK_products(pair, theta, xpad, valid, diag, st, rhs))
    log("slice f32 stages (ms, median of 5, each alone): %s"
        % json.dumps(stages))
    return stages


def profile_calls(calls, best_ms, label):
    """Device time of ``calls`` (each one evaluation) under
    ``torch.profiler``: the union of the device's busy intervals, the
    device operations (kernels and copies) launched, and the heaviest
    kernels, each per evaluation."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    calls[0]()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for call in calls:
            call()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / len(calls)
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev:
        log("%s profile: the profiler saw no device events; device time and "
            "idle share not measured" % label)
        return None
    busy_us, end = 0.0, float("-inf")
    for a, b in sorted((e.time_range.start, e.time_range.end) for e in dev):
        if b > end:
            busy_us += b - max(a, end)
            end = b
    by_name = {}
    for e in dev:
        t, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us(), c + 1)
    busy_ms = busy_us / 1e3 / len(calls)
    out = {"device_busy_ms_per_eval": busy_ms,
           "device_ops_per_eval": len(dev) / len(calls),
           "profiled_wall_ms_per_eval": wall_ms,
           "idle_share_profiled": 1.0 - busy_ms / wall_ms,
           "idle_share_vs_best_unprofiled": 1.0 - busy_ms / best_ms}
    log("%s profile (%d evaluations, torch.profiler): %s"
        % (label, len(calls), json.dumps(out)))
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    for name, (t, c) in top:
        log("  %8.3f ms/eval %8.1f calls/eval  %s"
            % (t / 1e3 / len(calls), c / len(calls), name[:100]))
    out["top"] = [[name[:100], t / 1e3 / len(calls), c / len(calls)]
                  for name, (t, c) in top]
    return out


def phase_slice_f64(device, n):
    import torch
    import george_tpu_torch as gtt

    x, y, yerr, kernel = smooth_dataset(n)
    out = {}
    gp = gtt.GP(kernel, solver=gtt.HODLRSolver, min_size=128, rank=12,
                device=device, dtype=torch.float64)
    t0 = time.perf_counter()
    gp.compute(x, yerr)
    ll = gp.log_likelihood(y)
    sync(device)
    log("slice f64: compute + log_likelihood %.3f s"
        % (time.perf_counter() - t0))
    out["gp_rel"] = check_anchor("slice f64 GP.log_likelihood", ll,
                                 ANCHOR_F64, n)

    t0 = time.perf_counter()
    g = gp.grad_log_likelihood(y)
    sync(device)
    log("slice f64 exact autograd gradient (%.3f s): %s"
        % (time.perf_counter() - t0, np.array2string(g, precision=10)))

    # central differences of the solver's own likelihood function: fixed
    # pivots, so the quotient differentiates the same compressed operator.
    # The skeleton interpolants solve ridge systems at their ridge floor,
    # which leaves the float64 likelihood jittering in theta at ~1e-9
    # relative (more at larger n): a step of 1e-5 measures that jitter,
    # not the slope (rel err 5e-4 at n=6e3, 1e-2 at n=3e4 on the CPU).
    # A five-point stencil at h=3e-2 keeps the truncation at O(h^4) and
    # the jitter at ~1e-6 of the gradient.
    f = gp.solver.loglike_fn()
    theta = gp.solver._theta
    diag = torch.as_tensor(gp._yerr2 + np.exp(gp._call_white_noise(gp._x)),
                           device=device, dtype=torch.float64)
    r = torch.as_tensor(y, device=device, dtype=torch.float64)
    h = 3e-2
    fd = np.empty(theta.shape[0])
    with torch.no_grad():
        for i in range(theta.shape[0]):
            e = torch.zeros_like(theta)
            e[i] = h

            def at(k):
                return float(f(theta + k * e, diag, r))

            fd[i] = (8 * (at(1) - at(-1)) - (at(2) - at(-2))) / (12 * h)
    rel = np.abs(g - fd) / np.abs(fd)
    log("slice f64 five-point differences (h=3e-2): %s; rel err %s "
        "(limit 1e-4)" % (np.array2string(fd, precision=10),
                          np.array2string(rel)))
    if not np.all(rel <= 1e-4):
        raise RuntimeError("exact gradient disagrees with finite differences")
    out["grad_fd_rel_max"] = float(rel.max())
    return out



# ---------------------------------------------------------------------------
# the sparse path's data and kernels
# ---------------------------------------------------------------------------

def bench_dia_dataset(n):
    """benchmarks/bench_dia.py's dataset, same numpy stream: x, the matvec
    right-hand side, y, yerr, kernel."""
    from george_tpu_torch import kernels

    rng = np.random.default_rng(0)
    x = np.sort(rng.uniform(0, n / 50.0, n))
    y_mv = rng.standard_normal(n)
    y = np.sin(x) + 0.1 * rng.standard_normal(n)
    kernel = kernels.WendlandC2Kernel(
        log_rc=np.log(2.0), kernel_base=kernels.ExpSquaredKernel(metric=1.0))
    return x, y_mv, y, 0.1, kernel


def dia_table(x, kernel, dtypes):
    """The bench's band on the card: radius query, offsets, value table per
    dtype (as ``SparseSolver.compute`` builds them), and the mask."""
    import torch
    from george_tpu_torch.neighbors import radius_neighbors_csr
    from george_tpu_torch.solvers import sparse as S

    idx, ptr = radius_neighbors_csr(x[:, None], kernel.get_cutoff())
    offsets, lo, hi = S.banded_offsets(idx, ptr)
    nbr, mask = S.banded_ell_tables(offsets, lo, hi, len(x))
    nbr = torch.as_tensor(nbr.astype(np.int64), device="cuda")
    mask = torch.as_tensor(mask, device="cuda")
    vals = {}
    for dtype in dtypes:
        xt = torch.as_tensor(x[:, None], device="cuda", dtype=dtype)
        th = torch.as_tensor(kernel.parameter_vector, device="cuda",
                             dtype=dtype)
        with torch.no_grad():
            vals[dtype] = S.ell_values(kernel.pair_fn, th, xt, nbr, mask)
    return offsets, vals, mask, int(ptr[-1])


def _random_band(n, offsets, r, dtype, seed):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    vals = torch.randn((n, len(offsets)), generator=g, device="cuda",
                       dtype=dtype)
    cols = (torch.arange(n, device="cuda")[:, None]
            + torch.as_tensor(np.asarray(offsets), device="cuda")[None, :])
    vals = torch.where((cols >= 0) & (cols < n), vals, 0.0).contiguous()
    diag = torch.rand(n, generator=g, device="cuda", dtype=dtype) + 1.0
    y = torch.randn((n, r), generator=g, device="cuda", dtype=dtype)
    return vals, diag, y


def _check_dia(label, vals, offsets, diag, y, tol):
    import torch
    from george_tpu_torch.ops import dia

    before = dia.dia_kernel_launches
    out = dia.dia_matvec_cuda(vals, offsets, diag, y)
    torch.cuda.synchronize()
    if dia.dia_kernel_launches != before + 1:
        raise RuntimeError("DIA launch counter did not rise")
    ref = dia.dia_matvec_plain(vals, offsets, diag, y)
    err = float((out - ref).abs().max())
    scale = float(ref.abs().max())
    log("kernel dia %s: max|d| %.3e = %.3e max|out| (limit %.0e)"
        % (label, err, err / scale, tol))
    if not (err <= tol * scale and bool(torch.isfinite(out).all())):
        raise RuntimeError("DIA kernel disagrees with plain: %s" % label)
    return out, err


def _csr_of_band(vals, offsets, mask, diag):
    """``K + diag`` as a torch CSR tensor over the radius query's pattern
    (the library yardstick's input; built outside any timed region)."""
    import torch

    n = vals.shape[0]
    cols = (torch.arange(n, device="cuda")[:, None]
            + torch.as_tensor(np.asarray(offsets), device="cuda")[None, :])
    values = vals.clone()
    values[:, -int(offsets[0])] += diag           # offset 0: the diagonal
    crow = torch.zeros(n + 1, dtype=torch.int64, device="cuda")
    crow[1:] = torch.cumsum(mask.sum(dim=1), 0)
    return torch.sparse_csr_tensor(
        crow.to(torch.int32), cols[mask].to(torch.int32), values[mask],
        size=(n, n), check_invariants=False)


def phase_kernel_dia(x, y_mv, kernel):
    import torch
    from george_tpu_torch.ops import dia

    t0 = time.perf_counter()
    offsets, vals, mask, nnz = dia_table(x, kernel,
                                         (torch.float32, torch.float64))
    n, D = vals[torch.float32].shape
    d_min = int(offsets[0])
    log("kernel dia: bench_dia table n=%d D=%d (offsets %d..%d), nnz %d, "
        "built in %.2f s" % (n, D, d_min, int(offsets[-1]), nnz,
                             time.perf_counter() - t0))
    out = {"n": n, "D": D, "nnz": nnz}
    g = torch.Generator(device="cuda").manual_seed(1)
    cases = {}
    # the path's column counts: 1 (CG solves), 16 Rademacher probes (SLQ
    # and the gradient's probe CG), 17 (the tangent applies, 16 + 1 in two
    # passes over each row); 40 takes three passes, the last one partial
    for dtype, r, tol in ((torch.float32, 1, 1e-5), (torch.float32, 16, 1e-5),
                          (torch.float32, 17, 1e-5), (torch.float32, 40, 1e-5),
                          (torch.float64, 4, 1e-12)):
        v = vals[dtype]
        diag = torch.full((n,), 0.01, device="cuda", dtype=dtype)
        if r == 1:
            y = torch.as_tensor(y_mv, device="cuda", dtype=dtype)
        elif r == 16:
            y = torch.randint(0, 2, (n, r), generator=g, device="cuda").to(
                dtype) * 2 - 1
        else:
            y = torch.randn((n, r), generator=g, device="cuda", dtype=dtype)
        if not dia.uses_shared_memory(D, r, dtype):
            raise RuntimeError("the bench band should take the shared-memory"
                               " variant")
        res, err = _check_dia("bench n=%d D=%d r=%d %s [shared]"
                              % (n, D, r, str(dtype).split(".")[-1]),
                              v, offsets, diag, y, tol)
        cases[(dtype, r)] = (v, diag, y, res, err)

    nr = n + 37
    rv, rd, ry = _random_band(nr, offsets, 17, torch.float32, 2)
    _check_dia("ragged n=%d D=%d r=17 f32" % (nr, D), rv, offsets, rd, ry,
               1e-5)
    wide = tuple(range(-1000, 1001))
    if dia.uses_shared_memory(len(wide), 32, torch.float32):
        raise RuntimeError("the wide band should take the device-memory "
                           "variant")
    wv, wd, wy = _random_band(50_000, wide, 32, torch.float32, 3)
    _check_dia("n=50000 D=%d r=32 f32 [device memory]" % len(wide), wv,
               wide, wd, wy, 1e-5)
    del rv, rd, ry, wv, wd, wy, cases[(torch.float32, 40)]

    for r in (1, 16, 17):
        v, diag, y, res, err = cases[(torch.float32, r)]
        A = _csr_of_band(v, offsets, mask, diag)
        lib = A @ y
        lib_err = float((lib - res).abs().max()) / float(res.abs().max())
        if lib_err > 1e-4:
            raise RuntimeError("the CSR yardstick computes another function "
                               "(rel %.3e)" % lib_err)
        t = {"max_abs_err": err,
             "ms": cuda_ms(lambda: dia.dia_matvec_cuda(v, offsets, diag, y)),
             "plain_ms": cuda_ms(
                 lambda: dia.dia_matvec_plain(v, offsets, diag, y)),
             "library_ms": cuda_ms(lambda: A @ y)}
        t["bound_ms"], t["bound_by"] = bound(
            v.element_size() * (n * D + n + 2 * n * r),
            2.0 * n * (D + 1) * r, v.dtype)
        t["share_of_bound"] = t["bound_ms"] / t["ms"]
        out["r%d" % r] = t
        log("kernel dia time n=%d D=%d r=%d f32, median of 21: kernel %.4f "
            "ms, plain %.4f ms, cuSPARSE CSR (nnz %d) %.4f ms, bound %.4f ms "
            "(%s), %.1f%% of bound" % (n, D, r, t["ms"], t["plain_ms"],
                                       A.values().numel(), t["library_ms"],
                                       t["bound_ms"], t["bound_by"],
                                       100 * t["share_of_bound"]))
        del A, lib
    return out


def phase_kernel_tiled():
    import torch
    from george_tpu_torch.ops import chol

    out = {}
    cases = [(8, 128, torch.float32, 3, 1e-4), (1024, 64, torch.float32, 8,
                                                 1e-4),
             (16, 64, torch.float64, 6, 1e-10),
             (4, 196, torch.float64, 0, 1e-10)]
    for B, m, dtype, per_cta, tol in cases:
        got = chol.tile_blocks_per_cta(m, dtype)
        if got != per_cta:
            raise RuntimeError("tiled (%d, %s): %d blocks per CTA, expected "
                               "%d" % (m, dtype, got, per_cta))
        A = _spd(B, m, dtype)
        before = chol.chol_tile_kernel_launches
        L = chol.cholesky_tiled_cuda(A)
        torch.cuda.synchronize()
        if chol.chol_tile_kernel_launches != before + 1:
            raise RuntimeError("tiled launch counter did not rise")
        L_ref = chol.cholesky_plain(A)
        err = float((L - L_ref).abs().max())
        scale = float(L_ref.abs().max())
        upper = bool((torch.triu(L, 1) == 0).all())
        log("kernel tiled (%d, %d) %s [%s]: max|dL| %.3e = %.3e max|L| "
            "(limit %.0e), upper zero %s"
            % (B, m, str(dtype).split(".")[-1],
               "%d per CTA" % per_cta if per_cta else "device", err,
               err / scale, tol, upper))
        if not (err <= tol * scale and upper
                and bool(torch.isfinite(L).all())):
            raise RuntimeError("tiled kernel disagrees with plain at (%d, %d)"
                               " %s" % (B, m, dtype))
        out["err_%d_%d_%s" % (B, m, str(dtype).split(".")[-1])] = err
    A = _spd(4, 128, torch.float32, jitter=1e-4, seed=5)
    L = chol.cholesky_tiled_cuda(A)
    torch.cuda.synchronize()
    rec = float((L @ L.mT - A).abs().max())
    log("kernel tiled near-singular (4, 128) f32: finite %s, max|LL^T - A| "
        "%.3e" % (bool(torch.isfinite(L).all()), rec))
    if not (bool(torch.isfinite(L).all()) and rec <= 5e-4):
        raise RuntimeError("tiled near-singular batch failed")

    for B, m in ((8, 128), (1024, 64)):
        A = _spd(B, m, torch.float32)
        chol.chol_tile_kernel_launches = 0
        t = {"ms": cuda_ms(lambda: chol.cholesky_tiled_cuda(A))}
        t["launches"] = chol.chol_tile_kernel_launches
        t["plain_ms"] = cuda_ms(lambda: chol.cholesky_plain(A))
        t["library_ms"] = cuda_ms(lambda: torch.linalg.cholesky(A))
        t["bound_ms"], t["bound_by"] = bound(chol_bytes(B, m, 4),
                                             B * m ** 3 / 3.0, A.dtype)
        t["max_abs_err"] = out["err_%d_%d_float32" % (B, m)]
        out["%dx%d" % (B, m)] = t
        log("kernel tiled time (%d, %d) f32, median of 21: kernel %.4f ms, "
            "plain %.4f ms, torch.linalg.cholesky %.4f ms, bound %.4f ms "
            "(%s)" % (B, m, t["ms"], t["plain_ms"], t["library_ms"],
                      t["bound_ms"], t["bound_by"]))
    return out


def phase_sparse_direct(data):
    """The exact banded path, float64 then float32, through ``GP``."""
    import torch
    import george_tpu_torch as gtt

    x, y, yerr, kernel = data
    out = {}
    for dtype in (torch.float64, torch.float32):
        name = str(dtype).split(".")[-1]
        gp = gtt.GP(kernel, solver=gtt.SparseSolver, device="cuda",
                    dtype=dtype)
        t0 = time.perf_counter()
        gp.compute(x, yerr)
        sync("cuda")
        t_compute = time.perf_counter() - t0
        t0 = time.perf_counter()
        ll = gp.log_likelihood(y)
        sync("cuda")
        t_ll = time.perf_counter() - t0
        t0 = time.perf_counter()
        grad = gp.grad_log_likelihood(y)
        sync("cuda")
        t_grad = time.perf_counter() - t0
        s = gp.solver
        if s._band_factors is None:
            raise RuntimeError("direct='auto' did not take the banded path")
        res = {"ll": ll, "grad": grad.tolist(),
               "quad": -2.0 * (ll - gp._const), "logdet": s.log_determinant,
               "n": len(x), "D": len(s._dia_offsets), "b": s._block_size,
               "compute_s": t_compute, "log_likelihood_s": t_ll,
               "grad_s": t_grad}
        log("sparse direct %s: n=%d D=%d b=%d blocks=%d; ll %.10f, logdet "
            "%.10f, grad %s; compute %.3f s, log_likelihood %.3f s, "
            "grad_log_likelihood %.3f s"
            % (name, res["n"], res["D"], res["b"], -(-res["n"] // res["b"]),
               ll, res["logdet"], np.array2string(grad, precision=8),
               t_compute, t_ll, t_grad))
        if not (np.isfinite(ll) and np.all(np.isfinite(grad))):
            raise RuntimeError("sparse direct %s: non-finite output" % name)
        out[name] = res
        del gp, s
        torch.cuda.empty_cache()
    r = abs(out["float32"]["ll"] - out["float64"]["ll"]) / abs(
        out["float64"]["ll"])
    out["f32_vs_f64_ll_rel"] = r
    log("sparse direct: f32 log-likelihood %.3e relative to f64 (limit 1e-4)"
        % r)
    if r > 1e-4:
        raise RuntimeError("sparse direct f32 is off f64")
    return out


def phase_sparse_iterative(data, ref):
    """``direct=False`` in float32: CG + SLQ + Hutchinson through the DIA
    kernel, each piece against the float64 direct path."""
    import torch
    import george_tpu_torch as gtt

    x, y, yerr, kernel = data
    gp = gtt.GP(kernel, solver=gtt.SparseSolver, direct=False, device="cuda",
                dtype=torch.float32)
    t0 = time.perf_counter()
    gp.compute(x, yerr)
    sync("cuda")
    t_compute = time.perf_counter() - t0
    s = gp.solver
    ll = gp.log_likelihood(y)
    it_ll = s.cg_iterations
    grad = gp.grad_log_likelihood(y)
    it_grad = s.cg_iterations
    out = {"ll": ll, "grad": grad.tolist(), "quad": -2.0 * (ll - gp._const),
           "logdet": s.log_determinant, "slq_stderr": s.log_determinant_std,
           "cg_iterations_dot_solve": it_ll,
           "cg_iterations_probes": it_grad, "maxiter": s.maxiter,
           "first_compute_s": t_compute}
    log("sparse iterative f32: n=%d D=%d; ll %.6f; CG iterations: dot_solve "
        "%d, gradient probes %d (maxiter %d); SLQ logdet %.6f +- %.6f "
        "(stderr); grad %s"
        % (len(x), len(s._dia_offsets), ll, it_ll, it_grad, s.maxiter,
           out["logdet"], out["slq_stderr"],
           np.array2string(grad, precision=6)))
    if max(it_ll, it_grad) >= s.maxiter:
        raise RuntimeError("CG reached maxiter")
    if not (np.isfinite(ll) and np.all(np.isfinite(grad))):
        raise RuntimeError("sparse iterative: non-finite output")
    out["quad_rel"] = float(rel(out["quad"], ref["quad"]))
    out["logdet_rel"] = float(rel(out["logdet"], ref["logdet"]))
    out["grad_rel"] = rel(grad, ref["grad"]).tolist()
    log("sparse iterative f32 vs direct f64: quad %.3e (limit 1e-3), logdet "
        "%.3e (limit 3e-2), grad %s (limit 0.15 each)"
        % (out["quad_rel"], out["logdet_rel"],
           np.array2string(np.asarray(out["grad_rel"]), precision=4)))
    if not (out["quad_rel"] <= 1e-3 and out["logdet_rel"] <= 0.03
            and max(out["grad_rel"]) <= 0.15):
        raise RuntimeError("sparse iterative f32 is off the direct f64 path")

    def best_of_3(fn):
        ts = []
        for _ in range(3):
            sync("cuda")
            t0 = time.perf_counter()
            fn()
            sync("cuda")
            ts.append(time.perf_counter() - t0)
        return min(ts), ts

    out["compute_s"], out["compute_s_all"] = best_of_3(
        lambda: gp.compute(x, yerr))
    out["log_likelihood_s"], out["log_likelihood_s_all"] = best_of_3(
        lambda: gp.log_likelihood(y))
    out["grad_s"], out["grad_s_all"] = best_of_3(
        lambda: gp.grad_log_likelihood(y))
    log("sparse iterative f32 (synchronized, best of 3): compute %.3f s, "
        "log_likelihood %.3f s, grad_log_likelihood %.3f s"
        % (out["compute_s"], out["log_likelihood_s"], out["grad_s"]))
    return out, gp, y


def phase_ell_2d():
    """The sparse solver on 2-D data: no band, so every apply is the ELL
    gather path; CG's solution against the apply's residual."""
    import torch
    import george_tpu_torch as gtt
    from george_tpu_torch import kernels

    n = 20_000
    rng = np.random.default_rng(4)
    side = np.sqrt(n * np.pi / 50.0)        # ~50 neighbours within r = 1
    x = rng.uniform(0, side, (n, 2))
    y = np.sin(x[:, 0]) * np.cos(x[:, 1]) + 0.1 * rng.standard_normal(n)
    k = kernels.WendlandC2Kernel(
        log_rc=0.0, ndim=2,
        kernel_base=kernels.ExpSquaredKernel(metric=[1.0, 1.0], ndim=2))
    s = gtt.SparseSolver(k, device="cuda", dtype=torch.float32)
    t0 = time.perf_counter()
    s.compute(x, 0.1)
    z = s.apply_inverse(y)
    sync("cuda")
    res = np.linalg.norm(s.apply_forward(z) - y) / np.linalg.norm(y)
    out = {"n": n, "nnz": s.nnz, "k_max": int(s._nbr.shape[1]),
           "cg_iterations": s.cg_iterations, "residual": float(res),
           "logdet": s.log_determinant, "seconds": time.perf_counter() - t0}
    log("sparse 2-D ELL f32: n=%d nnz %d (k_max %d), CG %d iterations, "
        "|(K+D)z - y|/|y| %.3e (limit 1e-4), logdet %.4f, %.2f s"
        % (n, s.nnz, out["k_max"], s.cg_iterations, res, s.log_determinant,
           out["seconds"]))
    if s._dia_offsets is not None or not (res <= 1e-4) or not np.isfinite(
            s.log_determinant):
        raise RuntimeError("2-D ELL check failed")
    return out


def main():
    smi = phase_device()
    import torch
    from george_tpu_torch.ops import chol, dia

    device = "cuda"
    build_s = phase_build()
    kern = phase_kernel()
    x, y_mv, y, yerr, kernel = bench_dia_dataset(N_DIA)
    kdia = phase_kernel_dia(x, y_mv, kernel)
    tile = phase_kernel_tiled()
    torch.cuda.empty_cache()

    # each path: its counts start at 0 right before it and are read right
    # after it, before the diagnostics below launch the kernels again
    chol.chol_kernel_launches = 0
    f32, evaluate, thetas, args = phase_slice_f32(device, N_MAIN)
    launches = chol.chol_kernel_launches
    log("slice f32: leaf Cholesky kernel launches %d" % launches)
    if launches == 0:
        raise RuntimeError("the main path never launched the leaf kernel")
    f32["stages"] = stage_breakdown(*args, device)
    f32["profile"] = profile_calls(
        [lambda th=th: evaluate(th) for th in thetas[:4]], f32["ms_per_eval"],
        "slice f32")

    chol.chol_kernel_launches = 0
    f64 = phase_slice_f64(device, N_MAIN)
    log("slice f64: leaf Cholesky kernel launches %d"
        % chol.chol_kernel_launches)
    if chol.chol_kernel_launches == 0:
        raise RuntimeError("the f64 path never launched the leaf kernel")
    del evaluate, thetas, args
    torch.cuda.empty_cache()

    data = (x, y, yerr, kernel)
    dia.dia_kernel_launches = 0
    direct = phase_sparse_direct(data)
    log("sparse direct: DIA kernel launches %d (the (K + D) alpha of the "
        "exact gradients)" % dia.dia_kernel_launches)

    dia.dia_kernel_launches = 0
    it, gp_it, y_it = phase_sparse_iterative(data, direct["float64"])
    dia_launches = dia.dia_kernel_launches
    log("sparse iterative f32: DIA kernel launches %d" % dia_launches)
    if dia_launches == 0:
        raise RuntimeError("the sparse iterative path never launched the DIA "
                           "kernel")
    it["profile"] = profile_calls(
        [lambda: gp_it.grad_log_likelihood(y_it)], it["grad_s"] * 1e3,
        "sparse iterative f32 grad_log_likelihood")
    del gp_it
    torch.cuda.empty_cache()
    ell = phase_ell_2d()

    log(json.dumps({"summary": {
        "build_s": build_s, "cusolver_ms": kern["cusolver_ms"],
        "f32": f32, "f64": f64, "dia_kernel": kdia, "tiled_kernel": tile,
        "sparse_direct": direct, "sparse_iterative": it,
        "sparse_ell_2d": ell}}))
    r1, r16, r17 = kdia["r1"], kdia["r16"], kdia["r17"]
    t = tile["1024x64"]
    print(json.dumps({"kernels": [
        {"name": "leaf_cholesky", "route": "cuda",
         "source": "george_tpu_torch/csrc/chol.cu",
         "replaces": "george_tpu/ops/chol.py:154",
         "launches": launches, "max_abs_err": kern["max_abs_err"],
         "ms": kern["ms"], "plain_ms": kern["plain_ms"],
         "bound_ms": kern["bound_ms"], "bound_by": kern["bound_by"],
         "library_ms": kern["library_ms"],
         "shape": "(512, 196) f32", "launches_in": "HODLR f32 main path"},
        {"name": "dia_matvec", "route": "cuda",
         "source": "george_tpu_torch/csrc/dia.cu",
         "replaces": "george_tpu/ops/dia.py:96",
         "launches": dia_launches, "max_abs_err": r1["max_abs_err"],
         "ms": r1["ms"], "plain_ms": r1["plain_ms"],
         "bound_ms": r1["bound_ms"], "bound_by": r1["bound_by"],
         "library_ms": r1["library_ms"],
         "shape": "n=%d D=%d r=1 f32" % (kdia["n"], kdia["D"]),
         "ms_r16": r16["ms"], "plain_ms_r16": r16["plain_ms"],
         "bound_ms_r16": r16["bound_ms"], "library_ms_r16": r16["library_ms"],
         "max_abs_err_r16": r16["max_abs_err"],
         "ms_r17": r17["ms"], "plain_ms_r17": r17["plain_ms"],
         "bound_ms_r17": r17["bound_ms"], "library_ms_r17": r17["library_ms"],
         "max_abs_err_r17": r17["max_abs_err"],
         "launches_in": "sparse iterative f32 path"},
        {"name": "cholesky_tiled", "route": "cuda",
         "source": "george_tpu_torch/csrc/chol.cu",
         "replaces": "george_tpu/ops/chol.py:61",
         "launches": t["launches"], "max_abs_err": t["max_abs_err"],
         "ms": t["ms"], "plain_ms": t["plain_ms"],
         "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
         "library_ms": t["library_ms"], "shape": "(1024, 64) f32",
         "launches_in": "its kernel phase's timed launches (on no solver "
                        "path)"},
    ]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
