# -*- coding: utf-8 -*-
"""Smoke run of the PyTorch/CUDA port (``george_tpu_torch``) on one GPU.

Drives the main path once through its public entry points, at the size the
project benchmarks: the HODLR marginal log-likelihood and its gradient at
n = 1e5 on the smooth 1-D dataset (ExpSquared + Matern32, skeleton rank 12,
``min_size`` 128: 9 levels, 512 leaf boxes of 196 points). Phases:

1. device: require CUDA, print the card, its power limit and the versions;
2. build: compile the hand-written CUDA kernels from ``csrc/``;
3. kernel: the leaf Cholesky kernel against its plain torch version on the
   card, both variants (shared and device memory), plus its time beside
   the plain version's and ``torch.linalg.cholesky``'s;
4. slice, float32: ``GP.compute`` + ``log_likelihood`` and the Hutchinson
   likelihood + gradient, both against the float64 truth anchor, the time
   per evaluation and the leaf kernel's launch count; then, outside that
   count, a per-stage breakdown and a ``torch.profiler`` window (device
   busy time, device operations and idle share per evaluation);
5. slice, float64: the likelihood against the anchor, and the exact
   autograd gradient against central finite differences.

Any failed check raises, and the script exits nonzero without printing its
last line, ``{"ok": true, "device": {...}}``. Run it from the repository
root with no arguments::

    python3 chip_smoke.py

It imports nothing of JAX or of the JAX package.
"""

import json
import os
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
    for line in compiler_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log("  ptxas: " + line.strip())
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
    log("kernel time (512, 196) f32, median of 21: kernel %.4f ms, plain "
        "%.4f ms, torch.linalg.cholesky %.4f ms"
        % (out["ms"], out["plain_ms"], out["cusolver_ms"]))
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


def profile_evaluations(evaluate, thetas, best_ms):
    """Device time of four evaluations under ``torch.profiler``: the union
    of the device's busy intervals, the device operations (kernels and
    copies) launched, and the heaviest kernels, each per evaluation."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    thetas = thetas[:4]
    evaluate(thetas[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for th in thetas:
            evaluate(th)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / len(thetas)
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev:
        log("slice f32 profile: the profiler saw no device events; device "
            "time and idle share not measured")
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
    busy_ms = busy_us / 1e3 / len(thetas)
    out = {"device_busy_ms_per_eval": busy_ms,
           "device_ops_per_eval": len(dev) / len(thetas),
           "profiled_wall_ms_per_eval": wall_ms,
           "idle_share_profiled": 1.0 - busy_ms / wall_ms,
           "idle_share_vs_best_unprofiled": 1.0 - busy_ms / best_ms}
    log("slice f32 profile (4 evaluations, torch.profiler): %s"
        % json.dumps(out))
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    for name, (t, c) in top:
        log("  %8.3f ms/eval %6.1f calls/eval  %s"
            % (t / 1e3 / len(thetas), c / len(thetas), name[:100]))
    out["top"] = [[name[:100], t / 1e3 / len(thetas)]
                  for name, (t, _) in top]
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


def main():
    smi = phase_device()
    import torch
    from george_tpu_torch.ops import chol

    device = "cuda"
    build_s = phase_build()
    kern = phase_kernel()

    # the main path: every count starts at 0 here and is read right after
    # its timed window, before the diagnostics below call the kernel again
    chol.chol_kernel_launches = 0
    f32, evaluate, thetas, args = phase_slice_f32(device, N_MAIN)
    launches = chol.chol_kernel_launches
    log("slice f32: leaf Cholesky kernel launches %d" % launches)
    if launches == 0:
        raise RuntimeError("the main path never launched the leaf kernel")
    f32["stages"] = stage_breakdown(*args, device)
    f32["profile"] = profile_evaluations(evaluate, thetas,
                                         f32["ms_per_eval"])

    chol.chol_kernel_launches = 0
    f64 = phase_slice_f64(device, N_MAIN)
    log("slice f64: leaf Cholesky kernel launches %d"
        % chol.chol_kernel_launches)
    if chol.chol_kernel_launches == 0:
        raise RuntimeError("the f64 path never launched the leaf kernel")

    log(json.dumps({"summary": {
        "build_s": build_s, "cusolver_ms": kern["cusolver_ms"],
        "f32": f32, "f64": f64}}))
    print(json.dumps({"kernels": [{
        "name": "leaf_cholesky",
        "route": "cuda",
        "source": "george_tpu_torch/csrc/chol.cu",
        "replaces": "george_tpu/ops/chol.py:154",
        "launches": launches,
        "max_abs_err": kern["max_abs_err"],
        "ms": kern["ms"],
        "plain_ms": kern["plain_ms"],
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
