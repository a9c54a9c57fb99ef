# -*- coding: utf-8 -*-
"""Smoke run of the PyTorch/CUDA port (``george_tpu_torch``) on one GPU.

Drives the port's paths once through their public entry points, at the
sizes the project benchmarks:

* the HODLR marginal log-likelihood and its gradient at n = 1e5 on the
  smooth 1-D dataset (ExpSquared + Matern32, skeleton rank 12, ``min_size``
  128: 9 levels, 512 leaf boxes of 196 points), and at bench.py's two
  other configurations: the smooth dataset at n = 1e6 (``min_size`` 256:
  11 levels, 2048 leaves of 489) and the quasi-periodic one at n = 1e5
  (rank 48);
* the compact-support sparse solver on the dataset of
  ``benchmarks/bench_dia.py``: n = 2e5 sorted points on [0, n/50], a
  ``WendlandC2Kernel`` (cutoff 2) over ``ExpSquaredKernel(metric=1)``,
  yerr 0.1, seed 0: about 200 neighbours per point, a band of about 301
  diagonals;
* the inference layer: NUTS at the n = 512 configuration of
  ``benchmarks/bench_nuts.py``, and ``GP.log_prob_fn`` on the two paths
  above under the samplers and ``minimize``;
* the rest of the HODLR surface: the symmetric factorization and
  ``GP.sample``, the factorization self-check, ``debug=True``, kNN-guided
  pivots, and the multi-output LCM model at n = 1e5; sampler checkpoints;
* the strong-admissibility H-matrix solver at the 2-D configuration of
  ``benchmarks/bench_hmatrix.py`` (``ExpSquaredKernel([1.5, 1.5])``,
  ``min_size`` 64, rank 16) up to n = 1e5, fitted there (reverse mode,
  the samplers' evaluator, ``minimize``) in float32;
* ``parallel`` and the solvers' ``mesh=`` on 2 ranks sharing the card;
* the eight examples through their PyTorch twins.

Phases:

1. device: require CUDA, print the card, its power limit and the versions;
2. build: compile the hand-written CUDA kernels from ``csrc/`` (one
   ``nvcc`` per source, all at once);
3. kernels, each against its plain torch version on the card, with its
   time beside the plain version's, a library call's and the card's bound:
   the leaf Cholesky (every variant of its launch plan; timed at (512,
   196) f32 and f64 and (2048, 489) f32 and f64, the leaves at n = 1e5 and
   1e6; (64, 157) f64 held to the plain version too),
   the DIA matvec (a small table first; f32 r = 1, 16, 17 and 40 and f64
   r = 4 on the bench_dia value table, a ragged n, an upper band, the
   device-memory variant; timed at r = 1, 16 and 17 through
   ``dia_matvec_cuda`` and through the solver's prepared apply, with the
   profiler's device time per call and the launch plan), the CG step
   (bench_dia's n = 2e5 in float32 at r = 1 and 16, on states the
   solver's DIA apply drives: the first step's blocks and the alpha and
   beta they imply against ``cg_step_plain``, both timed by CUDA events
   over 64 steps; its launches are then counted on phases 7-10, 17 (c)
   and 18, and must be 0 on the direct path) and the tiled
   Cholesky (one many-warp block per CTA and eight blocks per CTA, a
   near-singular batch; timed at (8, 128) and (1024, 64) f32);
4. HODLR slice, float32: ``GP.compute`` + ``log_likelihood`` and the
   Hutchinson likelihood + gradient, both against the float64 truth anchor,
   the time per evaluation and the leaf kernel's launch count; then, outside
   that count, a per-stage breakdown and a ``torch.profiler`` window;
5. HODLR slice, float64: the likelihood against the anchor, and the exact
   autograd gradient against central finite differences;
6. HODLR ``log_prob_fn`` over 4 chains through the samplers' batched
   evaluator, smooth n = 1e5, float32: one leaf launch of B = 2048 per
   batched evaluation, each chain against the unbatched call (the
   gradient gate in float64), the anchor, the peak memory of a batched
   reverse-mode evaluation, a short ``sample_hmc`` and a profile;
7. sparse slice, direct (exact banded Cholesky), float64 then float32: the
   float64 numbers are the exact reference of phases 8 and 9;
8. sparse slice, iterative (``direct=False``), float32: CG + SLQ +
   Hutchinson through the DIA kernel, each piece against its own bound,
   the DIA kernel's launch count, timings and a ``torch.profiler`` window
   over one gradient;
9. sparse ``log_prob_fn`` (``direct=False``), float32: value and gradient
   through the CG and SLQ adjoints and the DIA kernel against the direct
   float64 values, then ``minimize`` for 3 iterations;
10. a 2-D sparse check (the gather path, no band) at n = 2e4, float32;
11. NUTS at ``benchmarks/bench_nuts.py``'s n = 512 configuration (7
    parameters, 8 chains, max_depth 8, dense mass, segment_size 8) for
    ``NUTS_STEPS`` warmup and sample steps, float64 then float32:
    ``log_prob`` at the start vector against the CPU float64 port, finite
    samples, samples/s, acceptance, depth, divergence fraction, leapfrog
    steps, host reads, the posterior moments and a ``torch.profiler``
    window over 2 transitions (the dense path: no hand-written kernel).

12. the symmetric HODLR factorization (``sym=True``), smooth n = 1e5,
    float64 then float32: the anchor, the log-determinant against the SMW
    cascade on the same pivots, ``W W^T`` against the compressed matvec,
    the ``W^{-1}`` round trips, ``GP.sample`` at the computed points
    (``apply_sqrt``), the symmetric Hutchinson gradient against the exact
    float64 one, and the leaf kernel's launches;
13. the factorization self-check on a non-decaying kernel (it must warn),
    ``debug=True`` at n = 2e4 in float64 (the compression error against
    the exact kernel, the dense gradient comparison) and kNN-guided pivots
    (``knn=8``) at n = 1e5 in float32 against the anchor;
14. the multi-output LCM model of ``examples/multioutput.py::at_scale``
    (its data from the port's twin) at n = 1e5 (2 tasks of 5e4 points)
    through the hierarchical solver, with the task-1 prediction: rank 48
    in float64 and float32, and rank 96 with refinement in float64 (see
    ``phase_lcm`` for why);
15. after each NUTS run, its final state through ``checkpoint`` and back,
    bit for bit, and the ``diagnostics`` spans of the solvers' computes;
16. the H-matrix solver (``HMatrixSolver``) on bench_hmatrix's data: (a)
    n = 4000 in float64 and float32 against the recorded dense truth and
    the dense float64 solver on the card; (b) n = 16000: likelihoods and
    the 32-probe Hutchinson gradient against the dense float64 ones,
    the reverse-mode ``log_prob_fn`` gradient against the dense float64
    one in float64 and float32 with the near field stored and on the fly,
    ``GP.sample``, ``apply_sqrt`` twice against the matvec, and
    ``log_prob_fn`` over 2 chains in float32 under the samplers' batched
    evaluator; (c) n = 1e5 in float32 then float64: compute with its stage
    breakdown, the likelihood (float32 first and repeated, float64 once),
    ``dot_solve`` (float32), CG iterations, peak memory, the near field's
    bytes, a profile of one ``dot_solve``, and the two dtypes' likelihoods
    against each other; (f) the fit path at n = 1e5 in float32 on (c)'s
    data, after (c): ``GP.grad_log_likelihood`` (32 probes), one
    ``log_prob_fn`` value and reverse-mode gradient with its per-stage
    memory trace (the value against ``gp.log_likelihood``, the gradient
    against ``grad_log_likelihood``), 2 chains through the samplers'
    batched evaluator against their unbatched evaluations, and
    ``minimize`` for 2 iterations; (d)
    ``examples/spatial.py``'s assertions at n = 2000 beside the weak HODLR
    solver, through the port's twin; (e) the float64 1-D whitener on the
    smooth dataset at n = 2e4 against the dense solver, with the leaf
    kernel's launches;
17. parallel and the kernel API: (a) the CSR ``get_value(x, nns=)`` and
    ``get_gradient(x, nns=)`` on bench_dia's data (n = 2e5) in float64 and
    float32 against the sparse solver's entry table and the CPU, and
    ``2.0 * WendlandC2Kernel`` through ``SparseSolver``; then, on 2 gloo
    ranks sharing the card (``torch.multiprocessing``, each rank with a
    rendezvous and a join timeout): (b) ``HODLRSolver(mesh=)`` at the
    smooth n = 1e5 (256 leaves a rank) in float64 and float32 against the
    anchor and the one-rank run; (c) ``sharded_predict`` on the HODLR,
    sparse (CG through the DIA kernel) and H-matrix solvers against
    ``gp.predict``; (d) NUTS at bench_nuts's n = 512 configuration and
    the ensemble, sharded against unsharded; (e) a one-rank NCCL group
    running (c)'s HODLR case; (f) ``entry.dryrun_multichip(2)`` on the
    card; then on the same 2 ranks (g) ``HODLRSolver(mesh=, sym=True)``
    at the smooth n = 1e5 in float64 (256 leaves a rank) against the
    anchor and the one-rank ``sym=True`` run (log-determinant,
    ``apply_sqrt``, ``apply_inverse_sym_W``, ``GP.sample``, the exact
    gradient) and (h) ``SparseSolver(mesh=)``'s ``log_prob_fn`` on
    bench_dia's data at n = 5e4: float64 against the one-rank iterative
    run, float32 under ``vmap`` over 2 chains against the direct float64
    path at that n. Each rank counts its own launches;
18. the examples' PyTorch twins (``george_tpu_torch.examples``) on the
    card, each through its ``main`` with the launch counts set to 0
    before it: every twin at its default size, ``scaling`` also at
    n = 10,000, ``hyper`` at its ``--smoke`` iteration counts,
    ``multioutput``'s ``at_scale`` at n = 10,000; the examples' own
    asserts are the gate, and each leaf-kernel shape they launch is held
    to the plain version;
19. bench.py's other configurations, after phase 6, each part with its own
    leaf-kernel counts by shape: (a) the smooth dataset at n = 1e6 in
    float32 through ``GP(..., HODLRSolver, min_size=256, rank=12,
    grad_mode="hutchinson", num_probes=8)``: compute (the host ACA walk,
    the factor, the self-check) and ``log_likelihood`` against bench.py's
    anchor at 5e-3, the self-check residual, the Hutchinson likelihood +
    gradient (one refinement step) against the anchor and timed by
    bench.py's protocol, peak memory, a stage breakdown and a profile;
    (b) float64 on (a)'s structure and pivots: the likelihood against the
    anchor at 1e-6, and (a)'s float32 gradient against the float64 one on
    the same probes (0.2 of max|g|); (c) the quasi-periodic dataset at
    n = 1e5, rank 48, in float32 as (a) and in float64 against the anchor
    and the JAX package's CPU float64 value (1e-7); (d) ``BASELINE.md``
    row 3 (``tests/test_golden.py``'s qp data at n = 1e4): HODLR rank 64
    against the dense solver, float64, 1e-6;
20. the CUDA graph of ``HODLRSolver.loglike_fn``, after phase 19, on the
    benchmark's smooth (rank 12) and quasi-periodic (rank 48)
    configurations at n = 1e5 in float32: ``grad_and_value(log_prob_fn)``
    eagerly and through the graph, each call read to the host, in ms a
    call (median of 21), peak device memory allocated and reserved, and
    the leaf kernel's launches (the graphed route's warm-up, checking
    replay and replays, its capture none, each as many as an eager
    call's); whether the graph was
    captured (and the reason where it was not); the two routes' values
    and gradients against each other (1e-5 and 1e-3 relative: a gate for
    gross faults, float32 rounding parting them at ~1e-4 of the
    gradient); and a replay under
    ``torch.cuda.set_sync_debug_mode("error")``.

Any failed check raises, and the script exits nonzero without printing its
last line, ``{"ok": true, "device": {...}}``. Run it from the repository
root with no arguments::

    python3 chip_smoke.py

``python3 chip_smoke.py --unsharded-times A B B A`` instead times the
unsharded HODLR, sparse and NUTS paths (``unsharded_times``) of the ports
in the checkouts ``A`` and ``B`` in turns, each run in a process of its
own, to compare two versions on one card. ``python3 chip_smoke.py
--unchunked-peak`` measures the peak memory of one n = 1e6 Hutchinson
evaluation with the assemblies' chunk budget at its default and lifted
(``unchunked_peak``); ``python3 chip_smoke.py --cascade-dtype`` runs the
float32 n = 1e6 GP with the HODLR cascade in float32 and in float64
(``cascade_dtype``); ``python3 chip_smoke.py --hmatrix-memory`` prints the
per-stage device memory of one H-matrix ``log_prob_fn`` value and
gradient at n = 16000 and 1e5, rematerialized and through plain autograd
(``hmatrix_memory``).

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
# bench.py's two other anchors (bench.py:72-76), each at its tolerance:
# the smooth dataset at n = 1e6 (a rank-64 float64 factorization; bench.py
# runs it in float32 at min_size 256, rank 12, with one refinement step)
# and the quasi-periodic dataset at n = 1e5 (rank-96 float64; rank 48)
N_1E6 = 1_000_000
ANCHOR_1E6 = -217929.3465
ANCHOR_1E6_F32 = 5e-3
ANCHOR_QP = -6669.998996
ANCHOR_QP_TOL = 5e-3
ANCHORS = {("smooth", N_MAIN): ANCHOR, ("smooth", N_1E6): ANCHOR_1E6,
           ("qp", N_MAIN): ANCHOR_QP}
# the JAX package's own float64 log-likelihood of the qp dataset at
# n = 1e5: george_tpu.GP(kernel, solver=HODLRSolver, min_size=128,
# rank=48, seed=42) with its host ACA pivots, computed once on the CPU
# (JAX 0.9.0, x64). The port's float64 value sits a few 1e-8 from it: the
# two packages' ACA walks break near-ties differently
QP_JAX_F64 = -6669.9997322710
QP_JAX_F64_TOL = 1e-7
N_DIA = 200_000
# NUTS warmup and sample steps per dtype. bench_nuts's 200 + 200 took
# 1227 s in float64 alone on an H100 (57,698 batched leapfrog steps of
# 21 ms, host-bound), past this script's time limit, so
# the path runs 6 + 6 here (NUTS_STEPS = 200 is the full configuration;
# 25 + 25 until phase 17 added two more float64 runs of it, 15 + 15 until
# phase 17 (g), (h) and phase 18 took the script to 885 s of its 1200,
# 10 + 10 until phase 16 (f) took it to 1086 s)
NUTS_STEPS = 6
# benchmarks/bench_hmatrix.py: its headline n, and its recorded CPU-float64
# dense likelihoods of the seed-3 datasets at n = 4000 and 16000
N_HM = 100_000
HM_TRUTH_4000 = 2894.5753680081853
HM_TRUTH_16000 = 11762.457
# Lanczos steps of apply_sqrt in the n = 16000 check, and the CG
# iterations of the profiled n = 1e5 solve
HM_SQRT_STEPS = 200
HM_PROFILE_ITERS = 8
# the (B, m) float64 leaves that phase 16 gives the leaf kernel: the weak
# HODLR comparison of (d) and the symmetric 1-D whitener of (e); the kernel
# phase holds the kernel against its plain version at both
HM_WEAK_LEAVES = (16, 125)
HM_WHITENER_LEAVES = (256, 79)

# the card's published peaks (H100 SXM data sheet, at 700 W): device memory
# bytes/s, float32 FLOP/s outside the tensor cores, and float64 FLOP/s on
# them (the larger float64 rate; 34e12 outside them)
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 67e12}


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


def qp_kernel():
    """bench.py's quasi-periodic kernel (``tests/test_golden.py``'s too)."""
    from george_tpu_torch import kernels

    return 1.0 * kernels.ExpSquaredKernel(20.0) * kernels.ExpSine2Kernel(
        gamma=1.0, log_period=np.log(3.7))


def qp_dataset(n):
    """bench.py's quasi-periodic dataset, same numpy stream: x, y, yerr,
    kernel."""
    rng = np.random.default_rng(42)
    x = np.sort(rng.uniform(0, 1000.0, n))[:, None]
    y = (np.sin(2 * np.pi * x[:, 0] / 3.7) * np.cos(0.13 * x[:, 0])
         + 0.25 * rng.standard_normal(n))
    yerr = np.sqrt(0.0625) * np.ones(n)
    return x, y, yerr, qp_kernel()


DATASETS = {"smooth": smooth_dataset, "qp": qp_dataset}


def check_anchor(name, ll, rel_tol, n, variant="smooth", truth=None):
    """``ll`` against ``truth``, by default bench.py's anchor of the
    ``variant`` dataset at ``n`` (none: only finiteness is checked)."""
    if not np.isfinite(ll):
        raise RuntimeError("%s: non-finite log-likelihood %r" % (name, ll))
    if truth is None:
        truth = ANCHORS.get((variant, n))
    if truth is None:
        log("%s: ll %.10f (no anchor for %s at n=%d)"
            % (name, ll, variant, n))
        return None
    rel = abs(ll - truth) / abs(truth)
    log("%s: ll %.10f, reference %.10g, rel err %.3e (limit %.0e)"
        % (name, ll, truth, rel, rel_tol))
    if rel > rel_tol:
        raise RuntimeError("%s: %.3e off the anchor (limit %.0e)"
                           % (name, rel, rel_tol))
    return rel


def check_residual(name, solver, tol):
    """The factorization self-check's one-probe solve residual, which the
    first compute of a configuration measures."""
    r = solver.factor_residual
    log("%s: factorization self-check residual %s (limit %.0e)"
        % (name, "not measured (memoized)" if r is None else "%.3e" % r, tol))
    if r is None or not r <= tol:
        raise RuntimeError("%s: self-check residual %r over %.0e"
                           % (name, r, tol))
    return r


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
    regs, spills, name = {}, {}, None
    for line in compiler_log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "Used" in line and "registers" in line and name:
            regs[name] = int(line.split("Used")[1].split()[0])
        elif "spill" in line and name:
            spills[name] = sum(
                int(v) for v in re.findall(r"(\d+) bytes spill", line))
            if spills[name]:
                log("  ptxas spills: %s %s" % (name, line.strip()))
    if regs:
        log("  ptxas: %d kernels, %d-%d registers"
            % (len(regs), min(regs.values()), max(regs.values())))
    # the DIA kernel's instantiations, by their template arguments
    for name in sorted(regs):
        m = re.search(r"dia_stream_kernelI([fd])Li(\d+)ELi(\d+)ELi(\d+)E",
                      name)
        if m:
            log("  dia_stream_kernel<%s, R=%s, C=%s, NSEG=%s>: %d registers, "
                "%d bytes of spills"
                % ("float" if m.group(1) == "f" else "double", m.group(2),
                   m.group(3), m.group(4), regs[name], spills.get(name, 0)))
        elif "dia_device_kernel" in name:
            log("  dia_device_kernel<%s>: %d registers, %d bytes of spills"
                % ("float" if "IfE" in name else "double", regs[name],
                   spills.get(name, 0)))
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


def _check_chol(fn, counter, A, tol, label):
    """One launch of a Cholesky entry point against the plain version in
    the kernel's order of operations; returns max|dL|."""
    import torch
    from george_tpu_torch.ops import chol

    before = getattr(chol, counter)
    L = fn(A)
    torch.cuda.synchronize()
    if getattr(chol, counter) != before + 1:
        raise RuntimeError("%s: launch counter did not rise" % counter)
    L_ref = chol.cholesky_plain(A, panel=chol.PANEL)
    torch.cuda.synchronize()
    err = float((L - L_ref).abs().max())
    scale = float(L_ref.abs().max())
    upper = bool((torch.triu(L, 1) == 0).all())
    log("%s: max|dL| %.3e = %.3e max|L| (limit %.0e), upper zero %s"
        % (label, err, err / scale, tol, upper))
    if not (err <= tol * scale and upper and bool(torch.isfinite(L).all())):
        raise RuntimeError("%s disagrees with plain" % label)
    return err


def _near_singular(fn, label):
    import torch

    A = _spd(4, 128, torch.float32, jitter=1e-4, seed=5)
    L = fn(A)
    torch.cuda.synchronize()
    rec = float((L @ L.mT - A).abs().max())
    log("%s near-singular (4, 128) f32: finite %s, max|LL^T - A| %.3e"
        % (label, bool(torch.isfinite(L).all()), rec))
    if not (bool(torch.isfinite(L).all()) and rec <= 5e-4):
        raise RuntimeError("%s near-singular batch failed" % label)


def device_ms(fn, calls=10):
    """Milliseconds of device work per call of ``fn`` under
    ``torch.profiler``: the summed duration of the kernels and copies it
    launches, without the host's share that a pair of CUDA events around
    one call also counts."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev:
        return None
    return sum(e.time_range.elapsed_us() for e in dev) / 1e3 / calls


def device_ms_or_events(fn, calls=20):
    """``device_ms``, or where the profiler saw no device event the time of
    ``calls`` back-to-back launches between one pair of CUDA events, per
    call (the host's share hides behind the device's)."""
    import torch

    ms = device_ms(fn, calls=calls)
    if ms is not None:
        return ms
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / calls


def _time_chol(fn, A, plain_runs=21):
    """Kernel, plain and library times and the bound at ``A``'s shape; the
    kernel's and the library's device time per call beside them."""
    import torch
    from george_tpu_torch.ops import chol

    B, m, _ = A.shape
    t = {"ms": cuda_ms(lambda: fn(A)),
         "plain_ms": cuda_ms(lambda: chol.cholesky_plain(A, panel=chol.PANEL),
                             warmup=1, runs=plain_runs),
         "plain_runs": plain_runs,
         "library_ms": cuda_ms(lambda: torch.linalg.cholesky(A)),
         "device_ms": device_ms(lambda: fn(A)),
         "library_device_ms": device_ms(lambda: torch.linalg.cholesky(A))}
    t["bound_ms"], t["bound_by"] = bound(chol_bytes(B, m, A.element_size()),
                                         B * m ** 3 / 3.0, A.dtype)
    return t


def phase_kernel():
    import torch
    from george_tpu_torch.ops import chol

    out = {}
    # (B, m, dtype, variant of the leaf plan, tolerance of max|L|, timed)
    cases = [(512, 196, torch.float32, "shared", 1e-4, True),
             (512, 196, torch.float64, "shared", 1e-10, True),
             (2048, 489, torch.float32, "device", 1e-4, True),
             (2048, 489, torch.float64, "device", 1e-10, True),
             (64, 157, torch.float64, "shared", 1e-10, False),
             (64, 489, torch.float32, "device", 1e-4, False),
             (16, 196, torch.float64, "shared", 1e-10, False),
             HM_WHITENER_LEAVES + (torch.float64, "shared", 1e-10, False),
             HM_WEAK_LEAVES + (torch.float64, "shared", 1e-10, False),
             (2, 1900, torch.float32, "device-panel", 1e-4, False)]
    for B, m, dtype, variant, tol, timed in cases:
        plan = chol.launch_plan(B, m, dtype)
        if plan.variant != variant:
            raise RuntimeError("(%d, %s) takes the %s variant, expected %s"
                               % (m, dtype, plan.variant, variant))
        A = _spd(B, m, dtype)
        name = "%dx%d_%s" % (B, m, str(dtype).split(".")[-1])
        err = _check_chol(chol.cholesky_cuda, "chol_kernel_launches", A, tol,
                          "kernel (%d, %d) %s [%s, %d threads]"
                          % (B, m, name.split("_")[1], variant,
                             plan.group_threads))
        if timed:
            t = _time_chol(chol.cholesky_cuda, A,
                           plain_runs=5 if m > 256 else 21)
            t["max_abs_err"] = err
            t["plan"] = plan._asdict()
            out[name] = t
            log("kernel time (%d, %d) %s, median of 21: kernel %.4f ms, "
                "plain %.4f ms (median of %d), torch.linalg.cholesky %.4f ms,"
                " bound %.4f ms (%s); device time per call (profiler): "
                "kernel %s ms, library %s ms"
                % (B, m, name.split("_")[1], t["ms"], t["plain_ms"],
                   t["plain_runs"], t["library_ms"], t["bound_ms"],
                   t["bound_by"], t["device_ms"], t["library_device_ms"]))
        del A
    _near_singular(chol.cholesky_cuda, "kernel")
    out.update(out["512x196_float32"])
    out["cusolver_ms"] = out["library_ms"]
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


def hodlr_gp(label, device, variant, n, dtype, tol, **solver_kw):
    """``GP.compute`` and ``log_likelihood`` of bench.py's ``variant``
    dataset at ``n`` through ``HODLRSolver(**solver_kw)``: the likelihood
    against the dataset's anchor at ``tol``, the first compute's
    factorization self-check, the seconds of the host ACA walk, the factor
    and the self-check (the solver's ``diagnostics`` spans), and the peak
    device memory. Returns ``(gp, (x, y, yerr), out)``."""
    import torch
    import george_tpu_torch as gtt
    from george_tpu_torch import diagnostics

    x, y, yerr, kernel = DATASETS[variant](n)
    gp = gtt.GP(kernel, solver=gtt.HODLRSolver, device=device, dtype=dtype,
                **solver_kw)
    before = diagnostics.report()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gp.compute(x, yerr)
    sync(device)
    t1 = time.perf_counter()
    ll = gp.log_likelihood(y)
    sync(device)
    t2 = time.perf_counter()
    spans = {k: v["total_s"] - before.get(k, {"total_s": 0.0})["total_s"]
             for k, v in diagnostics.report().items()}
    st = gp.solver._struct
    out = {"n": n, "L": st.L, "leaves": [st.n_pad // st.m, st.m],
           "rank": st.rank, "compute_s": t1 - t0, "log_likelihood_s": t2 - t1,
           "aca_s": spans.get("hodlr.aca_pivots"),
           "factor_s": spans["hodlr.compute"],
           "self_check_s": spans.get("hodlr.self_check"),
           "refine_steps": gp.solver._refine_eff, "ll": ll,
           "peak_gb_compute_ll": torch.cuda.max_memory_allocated() / 1e9}
    log("%s: n=%d L=%d leaves %d x %d rank %d; compute %.3f s (spans: ACA "
        "walk %s s, factor %.3f s, self-check %s s), log_likelihood %.3f s "
        "(%d refinement steps); peak device memory %.3f GB"
        % (label, n, st.L, st.n_pad // st.m, st.m, st.rank, t1 - t0,
           out["aca_s"], out["factor_s"], out["self_check_s"], t2 - t1,
           out["refine_steps"], out["peak_gb_compute_ll"]))
    out["gp_rel"] = check_anchor("%s GP.log_likelihood" % label, ll, tol, n,
                                 variant)
    out["factor_residual"] = check_residual(
        label, gp.solver, 1e-2 if dtype == torch.float32 else 1e-6)
    return gp, (x, y, yerr), out


def hodlr_hutchinson(label, device, gp, y, variant, tol, repeats=3):
    """The Hutchinson likelihood + gradient through the functional path
    (8 probes from a seeded ``torch.Generator``, one refinement step) on
    ``gp``'s solver: the likelihood against the anchor at ``tol``, the
    peak device memory of one evaluation, then bench.py's protocol (16
    distinct thetas queued, one synchronize, best of ``repeats``).
    Returns ``(out, evaluate, thetas, args)``."""
    import torch
    from george_tpu_torch.solvers import hodlr as H

    n = gp.solver._struct.n
    pair, theta, xpad, valid, diag, r, st = args = _hutchinson_args(gp, y)
    gen = torch.Generator(device=device).manual_seed(0)

    def evaluate(th):
        return H.hodlr_loglike_and_grad_hutchinson(
            pair, th, xpad, valid, diag, r, st, generator=gen,
            num_probes=8, n_real=n, refine_steps=1)

    out = {}
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    ll_h, g_h = evaluate(theta)
    sync(device)
    out["peak_gb_eval"] = torch.cuda.max_memory_allocated() / 1e9
    out["resident_gb_before_eval"] = resident / 1e9
    g_h = g_h.cpu().numpy()
    out["hutch_rel"] = check_anchor("%s Hutchinson" % label, float(ll_h),
                                    tol, n, variant)
    log("%s Hutchinson gradient: %s; peak device memory of one evaluation "
        "%.3f GB (%.3f GB resident before it)"
        % (label, np.array2string(g_h), out["peak_gb_eval"],
           out["resident_gb_before_eval"]))
    if not np.all(np.isfinite(g_h)):
        raise RuntimeError("%s: non-finite Hutchinson gradient" % label)

    thetas = [theta + 1e-5 * k for k in range(16)]
    times = []
    for _ in range(repeats):
        sync(device)
        t0 = time.perf_counter()
        outs = [evaluate(th) for th in thetas]
        sync(device)
        times.append((time.perf_counter() - t0) / len(thetas) * 1e3)
        if not all(bool(torch.isfinite(o[0])) for o in outs):
            raise RuntimeError("non-finite log-likelihood in the timed run")
        del outs
    out["ms_per_eval"] = min(times)
    out["ms_per_eval_all"] = times
    log("%s Hutchinson ll+grad: %.3f ms/eval (best of %d x 16; all %s)"
        % (label, min(times), repeats, ", ".join("%.3f" % t for t in times)))
    return out, evaluate, thetas, args


def phase_slice_f32(device, n):
    import torch

    gp, (_, y, _), out = hodlr_gp("slice f32", device, "smooth", n,
                                  torch.float32, ANCHOR_F32, min_size=128,
                                  rank=12)
    hutch, evaluate, thetas, args = hodlr_hutchinson(
        "slice f32", device, gp, y, "smooth", ANCHOR_F32)
    out.update(hutch)
    return out, evaluate, thetas, args


def stage_breakdown(pair, theta, xpad, valid, diag, r, st, device,
                    label="slice f32"):
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
    log("%s stages (ms, median of 5, each alone): %s"
        % (label, json.dumps(stages)))
    return stages


def profile_calls(calls, best_ms, label):
    """Device time of ``calls`` (each one evaluation) under
    ``torch.profiler``: the union of the device's busy intervals, the
    device operations (kernels and copies) launched, and the heaviest
    kernels, each per evaluation; the idle share against the profiled wall
    time, and against ``best_ms`` (an unprofiled time) unless it is
    None."""
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
           "idle_share_vs_best_unprofiled":
               None if best_ms is None else 1.0 - busy_ms / best_ms}
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

    gp, (_, y, _), out = hodlr_gp("slice f64", device, "smooth", n,
                                  torch.float64, ANCHOR_F64, min_size=128,
                                  rank=12)

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
    out["grad"] = g.tolist()
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

    # a small table first: a pipeline that stalls shows here
    for r in (1, 16):
        sv, sd, sy = _random_band(5000, tuple(range(-150, 151)), r,
                                  torch.float32, 4)
        _check_dia("small n=5000 D=301 r=%d f32" % r, sv,
                   tuple(range(-150, 151)), sd, sy, 1e-5)
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
        plan = dia.launch_plan(n, D, r, dtype)
        if plan.variant != "stream" or not dia.uses_shared_memory(D, r,
                                                                  dtype):
            raise RuntimeError("the bench band should take the streaming "
                               "variant")
        log("kernel dia plan r=%d %s: %s"
            % (r, str(dtype).split(".")[-1], json.dumps(plan._asdict())))
        res, err = _check_dia("bench n=%d D=%d r=%d %s [stream]"
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
    sv, sd, sy = _random_band(700, tuple(range(2, 9)), 17, torch.float32, 5)
    _check_dia("upper band n=700 d_min=2 D=7 r=17 f32", sv,
               tuple(range(2, 9)), sd, sy, 1e-5)
    del rv, rd, ry, wv, wd, wy, sv, sd, sy, cases[(torch.float32, 40)]

    # the prepared apply the solver keeps for the band: same kernel, the
    # checks that cannot change between calls made once
    op = dia.DiaOperator(offsets, n)
    for r in (1, 16, 17):
        v, diag, y, res, err = cases[(torch.float32, r)]
        A = _csr_of_band(v, offsets, mask, diag)
        lib = A @ y
        lib_err = float((lib - res).abs().max()) / float(res.abs().max())
        if lib_err > 1e-4:
            raise RuntimeError("the CSR yardstick computes another function "
                               "(rel %.3e)" % lib_err)
        before = dia.dia_kernel_launches
        same = op(v, diag, y)
        if dia.dia_kernel_launches != before + 1 or not torch.equal(same,
                                                                    res):
            raise RuntimeError("the prepared apply is not the kernel's "
                               "launch")

        def kernel_call():
            return dia.dia_matvec_cuda(v, offsets, diag, y)

        def library_call():
            return A @ y

        # kernel, library, library, kernel: the two one-call event times
        # that are compared come from interleaved measurements
        ms_a = cuda_ms(kernel_call)
        lib_a = cuda_ms(library_call)
        lib_b = cuda_ms(library_call)
        ms_b = cuda_ms(kernel_call)
        t = {"max_abs_err": err, "ms": 0.5 * (ms_a + ms_b),
             "ms_runs": [ms_a, ms_b],
             "operator_ms": cuda_ms(lambda: op(v, diag, y)),
             "plain_ms": cuda_ms(
                 lambda: dia.dia_matvec_plain(v, offsets, diag, y)),
             "library_ms": 0.5 * (lib_a + lib_b),
             "library_ms_runs": [lib_a, lib_b],
             "device_ms": device_ms_or_events(kernel_call),
             "library_device_ms": device_ms_or_events(library_call)}
        t["wrapper_ms"] = t["operator_ms"] - t["device_ms"]
        t["bound_ms"], t["bound_by"] = bound(
            v.element_size() * (n * D + n + 2 * n * r),
            2.0 * n * (D + 1) * r, v.dtype)
        t["share_of_bound"] = t["bound_ms"] / t["device_ms"]
        out["r%d" % r] = t
        log("kernel dia time n=%d D=%d r=%d f32, one call between two "
            "events, median of 21: dia_matvec_cuda %.4f ms (%.4f, %.4f), the "
            "solver's prepared apply %.4f ms, plain %.4f ms, cuSPARSE CSR "
            "(nnz %d) %.4f ms (%.4f, %.4f), bound %.4f ms (%s); device time "
            "per call (profiler): kernel %.4f ms = %.1f%% of bound, cuSPARSE "
            "%.4f ms; prepared apply minus device time %.4f ms"
            % (n, D, r, t["ms"], ms_a, ms_b, t["operator_ms"], t["plain_ms"],
               A.values().numel(), t["library_ms"], lib_a, lib_b,
               t["bound_ms"], t["bound_by"], t["device_ms"],
               100 * t["share_of_bound"], t["library_device_ms"],
               t["wrapper_ms"]))
        del A, lib
    r1 = out["r1"]
    log("kernel dia r=1 against cuSPARSE CSR, one-call event times: %.4f ms "
        "against %.4f ms (%s)" % (r1["ms"], r1["library_ms"],
                                  "no greater" if r1["ms"] <= r1["library_ms"]
                                  else "GREATER"))
    return out


def phase_kernel_cg(data, steps=64):
    """The CG step kernel (``csrc/cg.cu``) at the sparse path's shapes:
    bench_dia's n = 2e5 in float32, r = 1 (the value's solve and its
    adjoint) and r = 16 (the probe solve), on CG states the solver's own
    DIA apply drives. Every step runs twice on the same state, through
    ``cg_step_plain`` (its result dropped) and the kernel, each timed by a
    pair of CUDA events around it alone (the apply before it keeps the
    card ahead of the host). The first step from ``X = 0`` is held to the
    plain one: every block to 1e-4 of its largest entry, and the alpha
    and beta each column implies (``X . P / P . P``; ``(P' - minv R') . P
    / P . P``) to 1e-4 relative, so that a wrong step length or direction
    update fails."""
    import torch
    import george_tpu_torch as gtt
    from george_tpu_torch.ops import cg

    x, _, _, yerr, kernel = data
    s = gtt.SparseSolver(kernel, direct=False, device="cuda",
                         dtype=torch.float32)
    s.compute(x[:, None], yerr)
    n = len(x)
    out = {"n": n, "D": len(s._dia_offsets)}
    minv = 1.0 / s._pdiag
    for r in (1, 16):
        B = torch.randn(n, r, device="cuda", generator=torch.Generator(
            "cuda").manual_seed(r))
        X, R = torch.zeros_like(B), B.clone()
        P = minv[:, None] * R
        rz = torch.sum(R * P, dim=0)
        b2 = torch.sum(B * B, dim=0)
        state = torch.zeros(2, dtype=torch.int32, device="cuda")
        work = cg.cg_workspace(X, R, P, minv, rz, b2, state)
        times = {"kernel": [], "plain": []}
        before = cg.cg_device_steps

        def timed(name, fn):
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            result = fn()
            t1.record()
            times[name].append((t0, t1))
            return result

        for k in range(steps):
            # an apply before each of the two: the card works on it while
            # the host enqueues the step
            AP = s._apply_fixed(P)
            P_old = P.clone() if k == 0 else None
            ref = timed("plain", lambda: cg.cg_step_plain(
                X, R, P, AP, minv, rz, b2, state, 0.0, 1 << 30))
            AP = s._apply_fixed(P)
            X, R, P, rz, state = timed("kernel", lambda: cg.cg_step_cuda(
                X, R, P, AP, minv, rz, b2, state, 0.0, 1 << 30, work))
            if k == 0:
                t = out["r%d" % r] = {"max_abs_err": max(
                    float((a - b).abs().max() / b.abs().max())
                    for a, b in zip((X, R, P, rz), ref[:4]))}
                p = P_old.double()
                pp = torch.sum(p * p, dim=0)
                implied = {}
                for name, (x1, r1, p1) in (("kernel", (X, R, P)),
                                           ("plain", ref[:3])):
                    z1 = minv.double()[:, None] * r1.double()
                    implied[name] = (
                        torch.sum(x1.double() * p, dim=0) / pp,
                        torch.sum((p1.double() - z1) * p, dim=0) / pp)
                t["alpha_rel_err"], t["beta_rel_err"] = (float(
                    ((a - b).abs() / b.abs()).max()) for a, b in zip(
                        implied["kernel"], implied["plain"]))
                if not (t["max_abs_err"] <= 1e-4
                        and t["alpha_rel_err"] <= 1e-4
                        and t["beta_rel_err"] <= 1e-4):
                    raise RuntimeError("cg step kernel r=%d is off its plain "
                                       "version: %s" % (r, json.dumps(t)))
        torch.cuda.synchronize()
        t["launches"] = cg.cg_device_steps - before
        if t["launches"] != steps or state.tolist() != [0, steps]:
            raise RuntimeError("cg step kernel r=%d: %d launches, state %s"
                               % (r, t["launches"], state.tolist()))
        for name, pairs in times.items():
            t["ms" if name == "kernel" else "plain_ms"] = float(np.median(
                [a.elapsed_time(b) for a, b in pairs]))
        # at the least P, AP, X, R and minv read, X, R and P written once;
        # 14 operations an entry (three sums, three updates, Z)
        t["bound_ms"], t["bound_by"] = bound(
            4 * (7 * n * r + n), 14.0 * n * r, torch.float32)
        log("kernel cg step n=%d r=%d f32 (band D=%d), median of %d steps "
            "by CUDA events: kernel %.4f ms, plain %.4f ms, bound %.4f ms "
            "(%s); first step against the plain one: %.3e of the largest "
            "entry (limit 1e-4), implied alpha %.3e and beta %.3e relative "
            "(limit 1e-4)"
            % (n, r, out["D"], steps, t["ms"], t["plain_ms"], t["bound_ms"],
               t["bound_by"], t["max_abs_err"], t["alpha_rel_err"],
               t["beta_rel_err"]))
    del s
    return out


def phase_kernel_tiled():
    import torch
    from george_tpu_torch.ops import chol

    out = {}
    # (B, m, dtype, blocks per CTA of the tiled plan, tolerance)
    cases = [(8, 128, torch.float32, 1, 1e-4),
             (1024, 64, torch.float32, 8, 1e-4),
             (16, 64, torch.float64, 1, 1e-10),
             (4, 196, torch.float64, 1, 1e-10)]
    for B, m, dtype, per_cta, tol in cases:
        plan = chol.launch_plan(B, m, dtype, tiled=True)
        if plan.blocks_per_cta != per_cta:
            raise RuntimeError("tiled (%d, %d, %s): %d blocks per CTA, "
                               "expected %d" % (B, m, dtype,
                                                plan.blocks_per_cta, per_cta))
        A = _spd(B, m, dtype)
        out["err_%d_%d_%s" % (B, m, str(dtype).split(".")[-1])] = _check_chol(
            chol.cholesky_tiled_cuda, "chol_tile_kernel_launches", A, tol,
            "kernel tiled (%d, %d) %s [%s, %d per CTA, %d threads each]"
            % (B, m, str(dtype).split(".")[-1], plan.variant, per_cta,
               plan.group_threads))
    _near_singular(chol.cholesky_tiled_cuda, "kernel tiled")

    for B, m in ((8, 128), (1024, 64)):
        A = _spd(B, m, torch.float32)
        chol.chol_tile_kernel_launches = 0
        t = _time_chol(chol.cholesky_tiled_cuda, A)
        t["launches"] = chol.chol_tile_kernel_launches
        t["max_abs_err"] = out["err_%d_%d_float32" % (B, m)]
        out["%dx%d" % (B, m)] = t
        log("kernel tiled time (%d, %d) f32, median of 21: kernel %.4f ms, "
            "plain %.4f ms, torch.linalg.cholesky %.4f ms, bound %.4f ms "
            "(%s); device time per call (profiler): kernel %s ms, library "
            "%s ms" % (B, m, t["ms"], t["plain_ms"], t["library_ms"],
                       t["bound_ms"], t["bound_by"], t["device_ms"],
                       t["library_device_ms"]))
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


# ---------------------------------------------------------------------------
# the inference layer
# ---------------------------------------------------------------------------

def nuts_model(device, dtype):
    """benchmarks/bench_nuts.py's configuration at n = 512, same numpy
    stream: the GP (7 parameters, white noise fitted), its log-posterior
    with the Gaussian prior of sd 3 around the start vector, the start
    vector and the 8 chains' starting points."""
    import torch
    import george_tpu_torch as gtt
    from george_tpu_torch import kernels

    rng = np.random.default_rng(0)
    n = 512
    x = np.sort(rng.uniform(0.0, 30.0, n))
    y = np.sin(x) * np.exp(-0.05 * x) + 0.1 * rng.standard_normal(n)
    kernel = 0.5 * kernels.ExpSquaredKernel(1.3) * kernels.ExpSine2Kernel(
        gamma=2.0, log_period=0.0) + 0.1 * kernels.Matern32Kernel(2.0)
    gp = gtt.GP(kernel, white_noise=np.log(1e-4), fit_white_noise=True,
                verbose=True, device=device, dtype=dtype)
    gp.compute(x, 0.1)
    v0 = gp.get_parameter_vector()
    center = torch.as_tensor(v0, device=device, dtype=dtype)

    def log_prior(th):
        return -0.5 * torch.sum(((th - center) / 3.0) ** 2)

    log_prob = gp.log_prob_fn(x, y, 0.1, gate_prior=False,
                              log_prior=log_prior)
    p0 = v0[None, :] + 1e-3 * rng.standard_normal((8, len(v0)))
    return gp, log_prob, v0, p0


def phase_nuts_512(dtype):
    """NUTS at the n = 512 configuration: 8 chains, max_depth 8,
    target_accept 0.8, dense mass, segment_size 8, ``NUTS_STEPS`` warmup
    and as many samples."""
    import torch
    from george_tpu_torch.sampling import sample_nuts

    name = str(dtype).split(".")[-1]
    device = "cuda"
    gp, log_prob, v0, p0 = nuts_model(device, dtype)
    _, lp_cpu, _, _ = nuts_model("cpu", torch.float64)
    start = torch.as_tensor(v0, device=device, dtype=dtype)
    lp_card = float(log_prob(start))
    lp_ref = float(lp_cpu(torch.as_tensor(v0, dtype=torch.float64)))
    tol = 1e-10 if dtype == torch.float64 else 1e-4
    r = abs(lp_card - lp_ref) / abs(lp_ref)
    log("nuts n=512 %s: log_prob at the start vector %.12f on the card, "
        "%.12f on the CPU in float64, rel %.3e (limit %.0e)"
        % (name, lp_card, lp_ref, r, tol))
    if not r <= tol:
        raise RuntimeError("nuts n=512 %s: log_prob disagrees with the CPU "
                           "float64 port" % name)
    p0 = torch.as_tensor(p0, device=device, dtype=dtype)
    kw = dict(max_depth=8, target_accept=0.8, dense_mass=True,
              segment_size=8)
    steps = NUTS_STEPS
    # a short run first: the libraries' first calls are set-up, not sampling
    sample_nuts(1, log_prob, p0, num_warmup=1, num_samples=1, **kw)
    sync(device)
    t0 = time.perf_counter()
    samples, stats = sample_nuts(0, log_prob, p0, num_warmup=steps,
                                 num_samples=steps, **kw)
    sync(device)
    seconds = time.perf_counter() - t0
    s = samples.double().cpu().numpy()
    if not np.all(np.isfinite(s)):
        raise RuntimeError("nuts n=512 %s: non-finite samples" % name)
    flat = s.reshape(-1, s.shape[-1])
    out = {"samples_per_sec": flat.shape[0] / seconds, "seconds": seconds,
           "draws": flat.shape[0],
           "mean_accept": float(stats["accept"].double().mean()),
           "mean_depth": float(stats["depth"].double().mean()),
           "divergence_frac": float(stats["diverging"].double().mean()),
           "leapfrog_evals": stats["leapfrog_evals"],
           "host_reads": stats["host_reads"],
           "ms_per_leapfrog": seconds * 1e3 / stats["leapfrog_evals"],
           "step_size": stats["step_size"].double().cpu().tolist(),
           "posterior_mean": flat.mean(0).tolist(),
           "posterior_sd": flat.std(0).tolist(),
           "names": list(gp.get_parameter_names()),
           "log_prob_rel_vs_cpu_f64": r}
    log("nuts n=512 %s (chip_smoke): %.3f samples/s (%d draws in %.3f s), "
        "mean accept %.4f, mean depth %.4f, divergence fraction %.4f, %d "
        "leapfrog steps of all chains (%.3f ms each), %d host reads"
        % (name, out["samples_per_sec"], out["draws"], seconds,
           out["mean_accept"], out["mean_depth"], out["divergence_frac"],
           out["leapfrog_evals"], out["ms_per_leapfrog"], out["host_reads"]))
    for nm, m, sd in zip(out["names"], out["posterior_mean"],
                         out["posterior_sd"]):
        log("  %-40s mean %+.6f sd %.6f" % (nm, m, sd))
    out["steps"] = steps
    out["profile"] = profile_calls(
        [lambda: sample_nuts(2, log_prob, p0, num_warmup=1, num_samples=1,
                             **kw)], None,
        "nuts n=512 %s, 2 transitions" % name)
    return out, (samples, stats)


def _recording_leaf_launches():
    """Wrap the leaf kernel's wrapper so that each launch's batch shape is
    recorded; returns the list and a function that unwraps it."""
    from george_tpu_torch.ops import chol

    shapes = []
    launch = chol.cholesky_cuda

    def recorded(A):
        shapes.append(tuple(A.shape))
        return launch(A)

    chol.cholesky_cuda = recorded
    return shapes, lambda: setattr(chol, "cholesky_cuda", launch)


def phase_hodlr_chains(device, n):
    """The HODLR log_prob over 4 chains through the samplers' batched
    evaluator (``vmap(grad_and_value)``), smooth n = 1e5, float32: one
    leaf launch of 4 x 512 blocks per evaluation, each chain against the
    unbatched call, the anchor, a short HMC run, memory and profile."""
    import torch
    import george_tpu_torch as gtt
    from george_tpu_torch.ops import chol
    from george_tpu_torch.sampling import hmc, sample_hmc

    x, y, yerr, kernel = smooth_dataset(n)
    gp = gtt.GP(kernel, solver=gtt.HODLRSolver, min_size=128, rank=12,
                device=device, dtype=torch.float32)
    t0 = time.perf_counter()
    gp.compute(x, yerr)
    sync(device)
    log("hodlr chains: compute %.3f s" % (time.perf_counter() - t0))
    log_prob = gp.log_prob_fn(x, y, yerr, gate_prior=False)
    truth = gp.get_parameter_vector()
    rng = np.random.default_rng(5)
    thetas = torch.as_tensor(
        truth[None, :] + 0.01 * rng.standard_normal((4, len(truth))),
        device=device, dtype=torch.float32)
    value_and_grad = hmc._make_value_and_grad(log_prob)
    out = {}

    shapes, unwrap = _recording_leaf_launches()
    try:
        before = chol.chol_kernel_launches
        times = []
        for _ in range(3):
            sync(device)
            t0 = time.perf_counter()
            lp, g = value_and_grad(thetas)
            sync(device)
            times.append(time.perf_counter() - t0)
        launched = chol.chol_kernel_launches - before
        log("hodlr chains: batched value + exact gradient of 4 chains, "
            "%.3f s (best of 3; all %s); leaf launches %d for 3 "
            "evaluations, batch shapes %s"
            % (min(times), ", ".join("%.3f" % t for t in times), launched,
               shapes))
        st = gp.solver._struct
        expected = (4 * st.n_pad // st.m, st.m, st.m)
        if launched != 3 or shapes != [expected] * 3 or (
                n == N_MAIN and expected[0] != 2048):
            raise RuntimeError("hodlr chains: expected one leaf launch of "
                               "B = 2048 per batched evaluation")
    finally:
        unwrap()
    out["batched_eval_s"] = min(times)
    out["batched_eval_s_all"] = times
    out["leaf_launch_batch"] = shapes[0][0]

    # each chain against the unbatched call. In float32 the exact reverse
    # gradient at this n is rounding-limited (the skeleton interpolants sit
    # at their ridge floor and amplify rounding): its distance from the
    # float64 gradient is printed beside the batched-unbatched difference,
    # and the gradient gate is held in float64, on the same data and
    # skeletons
    gp64 = gtt.GP(kernel, solver=gtt.HODLRSolver, min_size=128, rank=12,
                  device=device, dtype=torch.float64)
    gp64.compute(x, yerr)
    log_prob64 = gp64.log_prob_fn(x, y, yerr, gate_prior=False)
    lp64, g64 = hmc._make_value_and_grad(log_prob64)(thetas.double())
    single = torch.func.grad_and_value(log_prob)
    single64 = torch.func.grad_and_value(log_prob64)
    rels = []
    for c in range(4):
        g1, v1 = single(thetas[c])
        g1_64, v1_64 = single64(thetas[c].double())
        scale = float(g1_64.abs().max())
        r = {"value_f32": abs(float(lp[c]) - float(v1)) / abs(float(v1)),
             "grad_f32": float((g[c] - g1).abs().max()) / scale,
             "grad_f32_unbatched_vs_f64":
                 float((g1.double() - g1_64).abs().max()) / scale,
             "value_f64": abs(float(lp64[c]) - float(v1_64))
             / abs(float(v1_64)),
             "grad_f64": float((g64[c] - g1_64).abs().max()) / scale}
        rels.append(r)
        log("  chain %d: batched vs unbatched, f32 value rel %.3e (limit "
            "1e-5), f32 gradient max|d| %.3e of max|g| (the f32 gradient's "
            "own distance from f64: %.3e); f64 value rel %.3e (limit 1e-5), "
            "f64 gradient %.3e of max|g| (limit 1e-3)"
            % (c, r["value_f32"], r["grad_f32"],
               r["grad_f32_unbatched_vs_f64"], r["value_f64"],
               r["grad_f64"]))
    out["chain_rel"] = rels
    if not all(r["value_f32"] <= 1e-5 and r["value_f64"] <= 1e-5
               and r["grad_f64"] <= 1e-3 for r in rels):
        raise RuntimeError("hodlr chains: batched and unbatched disagree")
    del gp64, log_prob64, lp64, g64
    ll = float(log_prob(torch.as_tensor(truth, device=device,
                                        dtype=torch.float32)))
    out["anchor_rel"] = check_anchor("hodlr chains log_prob at the truth",
                                     ll, ANCHOR_F32, n)

    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    value_and_grad(thetas)
    sync(device)
    out["peak_gb_batched_grad"] = torch.cuda.max_memory_allocated() / 1e9
    out["resident_gb_before"] = base / 1e9
    log("hodlr chains: peak device memory of one batched reverse-mode "
        "evaluation %.3f GB (%.3f GB resident before it)"
        % (out["peak_gb_batched_grad"], out["resident_gb_before"]))

    t0 = time.perf_counter()
    samples, stats = sample_hmc(3, log_prob, thetas, num_warmup=5,
                                num_samples=5, num_leapfrog=4)
    sync(device)
    secs = time.perf_counter() - t0
    if not bool(torch.isfinite(samples).all()):
        raise RuntimeError("hodlr chains: non-finite HMC samples")
    out["hmc_s_per_transition"] = secs / 10
    out["hmc_accept"] = float(stats["accept"].double().mean())
    log("hodlr chains: sample_hmc 4 chains, 5 + 5 transitions of 4 leapfrog "
        "steps: %.3f s per transition (%d batched evaluations), mean "
        "accept %.3f" % (secs / 10, stats["leapfrog_evals"],
                         out["hmc_accept"]))
    out["profile"] = profile_calls([lambda: value_and_grad(thetas)],
                                   out["batched_eval_s"] * 1e3,
                                   "hodlr chains, one batched evaluation")
    return out


# phase 19: bench.py's other two configurations (bench.py:101-111,
# 160-176, 241-258) through the port's GP; the leaf kernel's launches of
# each part by shape, and the shape each part must launch
BENCH_1E6 = dict(min_size=256, rank=12, grad_mode="hutchinson", num_probes=8)
BENCH_QP = dict(min_size=128, rank=48, grad_mode="hutchinson", num_probes=8)
BENCH_LEAVES = {"smooth_1e6_f32": (2048, 489, 489, "float32"),
                "smooth_1e6_f64": (2048, 489, 489, "float64"),
                "qp_1e5_f32": (512, 196, 196, "float32"),
                "qp_1e5_f64": (512, 196, 196, "float64"),
                "baseline_row3": (64, 157, 157, "float64")}
# repeats of bench.py's 16-theta protocol at n = 1e6 and at qp n = 1e5
# (3 until phase 16 (f) needed the room)
BENCH_REPEATS = 2
# (b): the float32 Hutchinson gradient at n = 1e6 against the float64 one
# on the same pivots and probes, as a share of max|g|. Both packages sit
# near 4e-2 on a CPU rig of the same depth; a broken float32 cascade (at
# L = 13 the solve residual reached 9.0, bench.py:164-169) is far past it
GRAD_F32_VS_F64 = 0.2


def _padded_inputs(gp, x, y, dtype):
    """``gp``'s points, diagonal and residual in its solver's sorted, padded
    order, from the float64 data (not from the solver's own tensors, which
    hold them rounded to its dtype): ``xpad, valid, diag, r``."""
    import torch

    s = gp.solver
    st, perm, n = s._struct, s._perm, s._struct.n
    xs = np.asarray(x, dtype=np.float64)[perm]
    xpad = np.concatenate([xs, np.repeat(xs[-1:], st.n_pad - n, axis=0)])
    valid = np.zeros(st.n_pad, dtype=bool)
    valid[:n] = True
    diag = np.ones(st.n_pad)
    diag[:n] = (gp._yerr2 + np.exp(gp._call_white_noise(gp._x)))[perm]
    r = np.zeros(st.n_pad)
    r[:n] = np.asarray(y, dtype=np.float64)[perm]

    def t(a):
        return torch.as_tensor(a, device=s.device, dtype=dtype)

    return t(xpad), torch.as_tensor(valid, device=s.device), t(diag), t(r)


def _rademacher(num, n_pad, device, seed):
    """``(num, n_pad)`` float64 Rademacher probes from a seeded generator on
    ``device``, to hand the same probes to both dtypes."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    bits = torch.randint(0, 2, (num, n_pad), generator=g, device=device)
    return (2 * bits - 1).to(torch.float64)


def _bench_launches(label, stop, key):
    """Read the leaf kernel's launches of one part (``_p17_record``) and
    require the part's leaf shape among them."""
    launches = stop()
    log("%s: leaf Cholesky kernel launches %d, by shape %s"
        % (label, launches["leaf"], launches["leaf_by_shape"]))
    if launches["leaf"] == 0 or BENCH_LEAVES[key] not in launches[
            "leaf_shapes"]:
        raise RuntimeError("%s never launched the leaf kernel at %s"
                           % (label, BENCH_LEAVES[key]))
    return launches


def phase_bench_1e6(device, n=N_1E6, repeats=BENCH_REPEATS):
    """Phase 19 (a) and (b): bench.py's north-star configuration, the
    smooth dataset at n = 1e6, ``min_size`` 256 (L = 11, 2048 leaves of
    489), rank 12. (a) float32 through ``GP(..., HODLRSolver,
    grad_mode="hutchinson", num_probes=8)``: compute (ACA walk, factor,
    self-check) and ``log_likelihood`` (one refinement step) against the
    anchor, the Hutchinson likelihood + gradient through the functional
    path against it and timed, peak memory, then outside the count a
    stage breakdown and a profile of one evaluation. (b) float64 on (a)'s
    structure and pivots through the functional path: the likelihood
    against the anchor at 1e-6, and one Hutchinson evaluation on the same
    probes as one of (a)'s, which (a)'s float32 gradient is held to."""
    import torch
    from george_tpu_torch.solvers import hodlr as H

    out = {}
    stop = _p17_record()
    gp, (x, y, _), a = hodlr_gp("bench 1e6 f32", device, "smooth", n,
                                torch.float32, ANCHOR_1E6_F32, **BENCH_1E6)
    hutch, evaluate, thetas, args = hodlr_hutchinson(
        "bench 1e6 f32", device, gp, y, "smooth", ANCHOR_1E6_F32, repeats)
    a.update(hutch)
    pair, theta, xpad, valid, diag, r, st = args
    probes = _rademacher(8, st.n_pad, device, 1)
    _, g32 = H.hodlr_loglike_and_grad_hutchinson(
        pair, theta, xpad, valid, diag, r, st, probes=probes.float(),
        num_probes=8, n_real=n, refine_steps=1)
    g32 = g32.double().cpu().numpy()
    a["launches"] = _bench_launches("bench 1e6 f32", stop, "smooth_1e6_f32")
    a["stages"] = stage_breakdown(*args, device, label="bench 1e6 f32")
    a["profile"] = profile_calls([lambda: evaluate(thetas[1])],
                                 a["ms_per_eval"], "bench 1e6 f32")
    out["f32"] = a
    del evaluate, thetas, args, xpad, valid, diag, r
    xpad, valid, diag, r = _padded_inputs(gp, x, y, torch.float64)
    theta = torch.as_tensor(gp.kernel.parameter_vector, device=device,
                            dtype=torch.float64)
    del gp
    torch.cuda.empty_cache()

    b = {}
    stop = _p17_record()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with torch.no_grad():
        factors, logdet = H.hodlr_factor(pair, theta, xpad, valid, diag, st)
        z = H.hodlr_solve(factors, st, r)
        ll = float(-0.5 * (torch.dot(r, z) + logdet + n * np.log(2 * np.pi)))
    b["factor_solve_s"] = time.perf_counter() - t0
    b["peak_gb_factor_solve"] = torch.cuda.max_memory_allocated() / 1e9
    del factors, z
    b["rel"] = check_anchor("bench 1e6 f64 (a)'s pivots, factor + solve",
                            ll, ANCHOR_F64, n)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ll_h, g64 = H.hodlr_loglike_and_grad_hutchinson(
        pair, theta, xpad, valid, diag, r, st, probes=probes, num_probes=8,
        n_real=n, refine_steps=1)
    sync(device)
    b["hutch_s"] = time.perf_counter() - t0
    b["peak_gb_eval"] = torch.cuda.max_memory_allocated() / 1e9
    b["hutch_rel"] = check_anchor("bench 1e6 f64 Hutchinson", float(ll_h),
                                  ANCHOR_F64, n)
    g64 = g64.cpu().numpy()
    b["grad"] = g64.tolist()
    a["grad_shared_probes"] = g32.tolist()
    log("bench 1e6 f64: factor + solve %.3f s (peak %.3f GB), Hutchinson "
        "evaluation %.3f s (peak %.3f GB); gradient %s"
        % (b["factor_solve_s"], b["peak_gb_factor_solve"], b["hutch_s"],
           b["peak_gb_eval"], np.array2string(g64)))
    b["f32_grad_gap"] = _gate(
        "bench 1e6 f32 Hutchinson gradient vs f64 on the same probes, "
        "max|d| / max|g|",
        float(np.abs(g32 - g64).max() / np.abs(g64).max()), GRAD_F32_VS_F64)
    b["launches"] = _bench_launches("bench 1e6 f64", stop, "smooth_1e6_f64")
    out["f64"] = b
    return out


def phase_bench_qp(device, n=N_MAIN, repeats=BENCH_REPEATS):
    """Phase 19 (c): bench.py's quasi-periodic configuration at n = 1e5,
    ``min_size`` 128 (512 leaves of 196), rank 48, through ``GP``: float32
    as (a) (the likelihood and the Hutchinson likelihood + gradient with
    one refinement step, both against the anchor, timed), then float64
    against the anchor and against the JAX package's CPU float64 value."""
    import torch

    out = {}
    stop = _p17_record()
    gp, (_, y, _), c = hodlr_gp("bench qp f32", device, "qp", n,
                                torch.float32, ANCHOR_QP_TOL, **BENCH_QP)
    hutch, evaluate, thetas, args = hodlr_hutchinson(
        "bench qp f32", device, gp, y, "qp", ANCHOR_QP_TOL, repeats)
    c.update(hutch)
    c["launches"] = _bench_launches("bench qp f32", stop, "qp_1e5_f32")
    out["f32"] = c
    del gp, evaluate, thetas, args
    torch.cuda.empty_cache()

    stop = _p17_record()
    gp, _, c = hodlr_gp("bench qp f64", device, "qp", n, torch.float64,
                        ANCHOR_QP_TOL, **BENCH_QP)
    if n == N_MAIN:
        c["jax_f64_rel"] = check_anchor(
            "bench qp f64 vs the JAX package's CPU float64", c["ll"],
            QP_JAX_F64_TOL, n, truth=QP_JAX_F64)
    c["launches"] = _bench_launches("bench qp f64", stop, "qp_1e5_f64")
    out["f64"] = c
    return out


def phase_baseline_row3(device, n=10_000):
    """Phase 19 (d): ``BASELINE.md`` row 3 on the card, the data of
    ``tests/test_golden.py``'s quasi-periodic test (n = 1e4 on [0, 100]):
    ``HODLRSolver(min_size=128, rank=64)`` (64 leaves of 157) against the
    port's dense ``BasicSolver``, both float64, relative 1e-6."""
    import torch
    import george_tpu_torch as gtt

    rng = np.random.default_rng(42)
    x = np.sort(rng.uniform(0, 100.0, n))[:, None]
    yerr = 0.25 * np.ones(n)
    y = (np.sin(2 * np.pi * x[:, 0] / 3.7) * np.cos(0.13 * x[:, 0])
         + 0.25 * rng.standard_normal(n))
    stop = _p17_record()
    t0 = time.perf_counter()
    gp = gtt.GP(qp_kernel(), solver=gtt.HODLRSolver, min_size=128, rank=64,
                seed=42, device=device, dtype=torch.float64)
    gp.compute(x, yerr)
    ll_h = gp.log_likelihood(y)
    secs = time.perf_counter() - t0
    d = {"launches": _bench_launches("baseline row 3", stop,
                                     "baseline_row3")}
    ll_b = dense_gp(qp_kernel(), x, yerr, device).log_likelihood(y)
    d.update(hodlr_s=secs, ll_hodlr=ll_h, ll_dense=ll_b)
    d["rel"] = _gate("baseline row 3 (qp n=%d) HODLR rank 64 vs dense, "
                     "f64 rel" % n, abs(ll_h - ll_b) / abs(ll_b), 1e-6)
    return d


def _bench_times(label, part, card):
    """One line of a phase 19 part's times and peaks, with the card."""
    keys = ("compute_s", "aca_s", "factor_s", "self_check_s",
            "log_likelihood_s", "ms_per_eval", "factor_solve_s", "hutch_s",
            "hodlr_s",
            "peak_gb_compute_ll", "peak_gb_eval", "peak_gb_factor_solve")
    log("%s on %s: %s" % (label, card, json.dumps(
        {k: part[k] for k in keys if part.get(k) is not None})))


def phase_bench_configs(device, card, repeats=BENCH_REPEATS):
    """Phase 19: (a) and (b) smooth n = 1e6, (c) qp n = 1e5 at rank 48,
    (d) ``BASELINE.md`` row 3; the seconds of each in ``out["seconds"]``.
    Every time is printed again beside ``card``, the card's ``nvidia-smi``
    name and power limit."""
    import torch

    out, secs = {}, {}
    for key, fn in (("smooth_1e6", phase_bench_1e6),
                    ("qp_1e5", phase_bench_qp)):
        t0 = time.perf_counter()
        out[key] = fn(device, repeats=repeats)
        secs[key] = time.perf_counter() - t0
        for dt in ("f32", "f64"):
            _bench_times("bench configs (19) %s %s" % (key, dt),
                         out[key][dt], card)
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["baseline_row3"] = phase_baseline_row3(device)
    secs["baseline_row3"] = time.perf_counter() - t0
    _bench_times("bench configs (19) baseline_row3", out["baseline_row3"],
                 card)
    out["seconds"] = secs
    log("bench configs (19) on %s: seconds %s" % (card, json.dumps(secs)))
    return out


GRAPH_CONFIGS = {"smooth": dict(min_size=128, rank=12),
                 "qp": dict(min_size=128, rank=48)}


def _graph_variant(device, variant, card, calls=21):
    """One configuration of phase 20 (see the module docstring)."""
    import warnings

    import torch
    import george_tpu_torch as gtt
    from george_tpu_torch.ops import chol
    from george_tpu_torch.solvers import hodlr

    x, y, yerr, kernel = DATASETS[variant](N_MAIN)
    gp = gtt.GP(kernel, solver=gtt.HODLRSolver, device=device,
                dtype=torch.float32, **GRAPH_CONFIGS[variant])
    gp.compute(x, yerr)
    f = torch.func.grad_and_value(gp.log_prob_fn(x, y, yerr))
    theta0 = np.asarray(gp.get_parameter_vector())
    rng = np.random.default_rng(20)
    thetas = [torch.as_tensor(theta0 + 0.01 * rng.standard_normal(
        theta0.shape), device=device, dtype=torch.float32)
        for _ in range(calls + 3)]

    def call(theta):
        g, v = f(theta)
        return float(v.cpu()), g.cpu().numpy()

    def timed():
        # each route's reserved peak from the blocks in use, not from
        # what the other route's calls left cached
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        chol.chol_kernel_launches = 0
        first = time.perf_counter()
        answers = [call(t) for t in thetas[:3]]
        first = time.perf_counter() - first
        ms = []
        for t in thetas[3:]:
            t0 = time.perf_counter()
            call(t)
            ms.append(1e3 * (time.perf_counter() - t0))
        return (answers, float(np.median(ms)), first,
                torch.cuda.max_memory_allocated() / 1e9,
                torch.cuda.max_memory_reserved() / 1e9,
                chol.chol_kernel_launches)

    route = hodlr.HODLRSolver._graph_route
    hodlr.HODLRSolver._graph_route = lambda *args: False  # the eager sweeps
    try:
        eager, eager_ms, eager_first, eager_gb, eager_res, eager_n = timed()
    finally:
        hodlr.HODLRSolver._graph_route = route
    captures = hodlr.graph_captures
    replays = hodlr.graph_replays
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        graphed, graph_ms, graph_first, graph_gb, graph_res, graph_n = \
            timed()
    refused = [str(w.message) for w in caught if "CUDA graph" in
               str(w.message)]
    captured = gp.solver._graph is not None
    vgap = max(abs(a[0] - b[0]) / abs(b[0]) for a, b in zip(graphed, eager))
    ggap = max(float(np.max(np.abs(a[1] - b[1])) / np.max(np.abs(b[1])))
               for a, b in zip(graphed, eager))
    out = {"captured": captured, "refused": refused[0] if refused else None,
           "captures": hodlr.graph_captures - captures,
           "replays": hodlr.graph_replays - replays,
           "eager_ms": eager_ms, "graph_ms": graph_ms,
           "eager_first3_s": eager_first, "graph_first3_s": graph_first,
           "eager_peak_gb": eager_gb, "graph_peak_gb": graph_gb,
           "eager_reserved_gb": eager_res, "graph_reserved_gb": graph_res,
           "eager_leaf_launches": eager_n, "graph_leaf_launches": graph_n,
           "value_gap": vgap, "grad_gap": ggap}
    # the leaf kernel's launches: eager, one set a call; graphed, the
    # warm-up's, the constructor's checking replay's and one set a replay,
    # the capture's none
    per_call = eager_n // len(thetas)
    want_n = per_call * (out["replays"] + 2) if captured else graph_n
    if not (per_call >= 1 and eager_n == per_call * len(thetas)
            and graph_n == want_n and (not captured or
                                       gp.solver._graph.launches == per_call)):
        raise RuntimeError("hodlr graph %s: leaf launches eager %d, graphed "
                           "%d (want %d)" % (variant, eager_n, graph_n,
                                             want_n))
    if captured:
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            g, v = f(thetas[0])
        finally:
            torch.cuda.set_sync_debug_mode("default")
        out["sync_free_replay"] = True
    log("hodlr graph (20) %s on %s: %s" % (variant, card, json.dumps(out)))
    # float32: the two routes round differently (the graph's LU batches
    # in cuBLAS slices, its reverse sweep on the forward's LU factors);
    # the gate is for gross faults, the benchmark holds both to float64
    if not (vgap <= 1e-5 and ggap <= 1e-3):
        raise RuntimeError("hodlr graph %s: %s %.3g / %.3g off the eager "
                           "sweeps" % (variant, "the replay is" if captured
                                       else "the fallback is", vgap, ggap))
    if variant == "smooth" and not captured:
        raise RuntimeError("hodlr graph: the smooth configuration was not "
                           "captured: %s" % out["refused"])
    return out


def phase_hodlr_graph(device, card):
    """Phase 20: the graphed ``loglike_fn`` against the eager sweeps."""
    import torch

    out = {}
    for variant in ("smooth", "qp"):
        out[variant] = _graph_variant(device, variant, card)
        torch.cuda.empty_cache()
    return out


def phase_sparse_log_prob(data, ref):
    """``log_prob_fn`` on the sparse iterative path (``direct=False``),
    bench_dia n = 2e5, float32: CG and SLQ with their adjoints through the
    DIA kernel, against the direct float64 values; then three iterations
    of ``minimize``."""
    import torch
    import george_tpu_torch as gtt
    from george_tpu_torch.ops import dia
    from george_tpu_torch.sampling import minimize

    x, y, yerr, kernel = data
    device = "cuda"
    gp = gtt.GP(kernel, solver=gtt.SparseSolver, direct=False, device=device,
                dtype=torch.float32)
    gp.compute(x, yerr)
    f = gp.log_prob_fn(x, y, yerr)
    theta = torch.as_tensor(gp.get_parameter_vector(), device=device,
                            dtype=torch.float32)
    before = dia.dia_kernel_launches
    sync(device)
    t0 = time.perf_counter()
    g, ll = torch.func.grad_and_value(f)(theta)
    sync(device)
    secs = time.perf_counter() - t0
    launches = dia.dia_kernel_launches - before
    ll = float(ll)
    g = g.double().cpu().numpy()
    n = len(x)
    logdet = gp.solver.log_determinant
    quad = -2.0 * ll - logdet - n * np.log(2.0 * np.pi)
    out = {"ll": ll, "grad": g.tolist(), "seconds": secs,
           "dia_launches": launches, "logdet": logdet, "quad": quad,
           "quad_rel": float(rel(quad, ref["quad"])),
           "logdet_rel": float(rel(logdet, ref["logdet"])),
           "grad_rel": rel(g, ref["grad"]).tolist()}
    log("sparse log_prob f32 (direct=False): value + gradient %.3f s, DIA "
        "launches %d; ll %.6f, quad (from ll and the solver's SLQ logdet) "
        "%.3e rel (limit 1e-3), logdet %.3e rel (limit 3e-2), gradient %s "
        "rel (limit 0.15 each) against direct float64"
        % (secs, launches, ll, out["quad_rel"], out["logdet_rel"],
           np.array2string(np.asarray(out["grad_rel"]), precision=4)))
    if launches <= 0:
        raise RuntimeError("sparse log_prob never launched the DIA kernel")
    if not (np.isfinite(ll) and np.all(np.isfinite(g))
            and out["quad_rel"] <= 1e-3 and out["logdet_rel"] <= 0.03
            and max(out["grad_rel"]) <= 0.15):
        raise RuntimeError("sparse log_prob is off the direct f64 path")

    t0 = time.perf_counter()
    res = minimize(gp, y, options={"maxiter": 3})
    sync(device)
    out["minimize_s"] = time.perf_counter() - t0
    out["minimize_nfev"] = int(res.nfev)
    out["minimize_nit"] = int(res.nit)
    log("sparse log_prob: minimize (L-BFGS-B, maxiter 3) %.3f s, %d "
        "function evaluations, %d iterations, ll %.6f -> %.6f"
        % (out["minimize_s"], res.nfev, res.nit, ll, -float(res.fun)))
    if not np.isfinite(res.fun):
        raise RuntimeError("sparse minimize ended non-finite")
    return out


def phase_sym(device, n, dtype, g_exact):
    """Symmetric HODLR (``sym=True``) at the smooth dataset: the anchor,
    the log-determinant against the SMW cascade on the same pivots, ``W
    W^T`` against the compressed matvec, the ``W^{-1}`` round trips,
    ``GP.sample`` and the symmetric Hutchinson gradient against the exact
    float64 gradient ``g_exact``."""
    import torch
    import george_tpu_torch as gtt
    from george_tpu_torch.ops import chol
    from george_tpu_torch.solvers import hodlr as H

    name = str(dtype).split(".")[-1]
    f64 = dtype == torch.float64
    x, y, yerr, kernel = smooth_dataset(n)
    out = {}
    # a fresh memo, so that this solver's self-check runs
    gtt.HODLRSolver._checked_configs.clear()
    gp = gtt.GP(kernel, solver=gtt.HODLRSolver, min_size=128, rank=12,
                sym=True, verbose=True, device=device, dtype=dtype)
    sync(device)
    t0 = time.perf_counter()
    gp.compute(x, yerr)
    sync(device)
    out["sym_compute_s"] = time.perf_counter() - t0
    s = gp.solver
    out["factor_residual"] = check_residual("sym %s" % name, s,
                                            1e-6 if f64 else 1e-2)
    ll = gp.log_likelihood(y)
    out["anchor_rel"] = check_anchor("sym %s GP.log_likelihood" % name, ll,
                                     ANCHOR_F64 if f64 else ANCHOR_F32, n)

    # the SMW cascade on the same data; its ACA walk runs on the host in
    # float64, so it picks the same pivots
    gpn = gtt.GP(kernel, solver=gtt.HODLRSolver, min_size=128, rank=12,
                 verbose=True, device=device, dtype=dtype)
    sync(device)
    t0 = time.perf_counter()
    gpn.compute(x, yerr)
    sync(device)
    out["nonsym_compute_s"] = time.perf_counter() - t0
    sn, st = gpn.solver, s._struct
    if not all(np.array_equal(st.flat[k], sn._struct.flat[k])
               for k in ("rp_all", "cp_all")):
        raise RuntimeError("sym %s: the two solvers' pivots differ" % name)
    out["logdet_rel_vs_smw"] = abs(s.log_determinant - sn.log_determinant
                                   ) / abs(sn.log_determinant)
    tol = 1e-9 if f64 else 1e-4
    log("sym %s: log-determinant %.10f, SMW %.10f, rel %.3e (limit %.0e)"
        % (name, s.log_determinant, sn.log_determinant,
           out["logdet_rel_vs_smw"], tol))
    if not out["logdet_rel_vs_smw"] <= tol:
        raise RuntimeError("sym %s: log-determinant off the SMW one" % name)

    gen = torch.Generator(device=device).manual_seed(3)
    V = torch.randn((8, st.n_pad), generator=gen, device=device,
                    dtype=dtype) * s._valid
    with torch.no_grad():
        WWtV = H._sqrt_matvec_t(
            s._factors, st, H._sqrt_matvec_t(s._factors, st, V,
                                             transpose=True))
        KV = H._matvec_factors_t(sn._factors, st, V)
    out["wwt_rel"] = float(torch.linalg.vector_norm(WWtV - KV)
                           / torch.linalg.vector_norm(KV))
    tol = 1e-8 if f64 else 1e-3
    log("sym %s: W (W^T V) against the compressed matvec, 8 probes, rel "
        "%.3e (limit %.0e)" % (name, out["wwt_rel"], tol))
    if not out["wwt_rel"] <= tol:
        raise RuntimeError("sym %s: W W^T is not the compressed operator"
                           % name)
    del WWtV, KV, V

    # the two factorizations alone, warm (a first call of a library
    # routine pays its set-up), each between synchronizations, best of 3;
    # their leaf launches are timing, not the path's, and leave the count
    launches = chol.chol_kernel_launches
    args = (kernel.pair_fn, s._theta, s._xpad, s._valid, s._diag_pad, st)
    for key, fn in (("sym_factor_ms", H.hodlr_factor_sym),
                    ("smw_factor_ms", H.hodlr_factor)):
        times = []
        with torch.no_grad():
            for _ in range(4):
                sync(device)
                t0 = time.perf_counter()
                fn(*args)
                sync(device)
                times.append((time.perf_counter() - t0) * 1e3)
        out[key] = min(times[1:])
    chol.chol_kernel_launches = launches
    log("sym %s: factorization alone, warm, best of 3: symmetric %.3f ms, "
        "SMW %.3f ms" % (name, out["sym_factor_ms"], out["smw_factor_ms"]))
    del gpn, sn

    Vh = np.random.default_rng(4).standard_normal((n, 4))
    for transpose, label in ((False, "W^{-1} W"), (True, "W^{-T} W^T")):
        back = s._apply_sym_W(s._apply_sym_W(Vh, False, transpose), True,
                              transpose)
        r = float(np.linalg.norm(back - Vh) / np.linalg.norm(Vh))
        out["roundtrip_rel_" + ("T" if transpose else "N")] = r
        log("sym %s: %s round trip, 4 columns, rel %.3e (limit %.0e)"
            % (name, label, r, tol))
        if not r <= tol:
            raise RuntimeError("sym %s: %s round trip failed" % (name, label))

    R = np.random.default_rng(5).standard_normal((8, n))
    times = []
    for _ in range(3):
        sync(device)
        t0 = time.perf_counter()
        s.apply_sqrt(R)
        times.append((time.perf_counter() - t0) * 1e3)
    out["apply_sqrt_ms_8_rows"] = min(times)
    np.random.seed(0)
    draws = gp.sample(size=8)
    if draws.shape != (8, n) or not np.all(np.isfinite(draws)):
        raise RuntimeError("sym %s: GP.sample gave %s draws"
                           % (name, draws.shape))
    out["sample_sd"] = float(draws.std())
    log("sym %s: compute %.3f s (SMW compute %.3f s), apply_sqrt of 8 rows "
        "%.3f ms (best of 3, host clock with the copies), GP.sample(8) "
        "finite, sd %.4f"
        % (name, out["sym_compute_s"], out["nonsym_compute_s"],
           out["apply_sqrt_ms_8_rows"], out["sample_sd"]))

    gh = gtt.GP(kernel, solver=gtt.HODLRSolver, min_size=128, rank=12,
                sym=True, grad_mode="hutchinson", num_probes=64,
                device=device, dtype=dtype)
    gh.compute(x, yerr)
    t0 = time.perf_counter()
    g = gh.grad_log_likelihood(y)
    out["sym_hutchinson_s"] = time.perf_counter() - t0
    g_exact = np.asarray(g_exact)
    ok = np.allclose(g, g_exact, rtol=0.2, atol=0.5)
    out["sym_hutchinson_rel"] = (np.abs(g - g_exact) / np.abs(g_exact)
                                 ).tolist()
    log("sym %s: symmetric Hutchinson gradient (64 probes, %.3f s) %s; "
        "exact f64 %s; rel %s (bounds rtol 0.2, atol 0.5)"
        % (name, out["sym_hutchinson_s"], np.array2string(g),
           np.array2string(g_exact),
           np.array2string(np.asarray(out["sym_hutchinson_rel"]))))
    if not ok:
        raise RuntimeError("sym %s: Hutchinson gradient off the exact one"
                           % name)
    return out


def phase_selfcheck_knn(device, n_debug, n_knn):
    """The self-check on a non-decaying kernel (it must warn), ``debug=True``
    with the Hutchinson gradient at ``n_debug`` (2e4) in float64, and
    ``knn=8`` at ``n_knn`` (1e5) in float32 against the anchor."""
    import warnings

    import torch
    import george_tpu_torch as gtt
    from george_tpu_torch import kernels

    out = {}
    rng = np.random.default_rng(0)
    xp = np.sort(rng.uniform(0, 10, 240))
    gtt.HODLRSolver._checked_configs.clear()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        gp = gtt.GP(0.2 * kernels.PolynomialKernel(log_sigma2=0.0, order=3),
                    solver=gtt.HODLRSolver, min_size=32, rank=24,
                    device=device, dtype=torch.float64)
        gp.compute(xp, 0.25)
    warned = any("self-check" in str(w.message) for w in caught)
    out["nondecaying_residual"] = gp.solver.factor_residual
    log("self-check, Polynomial(order 3) n=240 f64: warned %s, residual "
        "%.3e (must exceed 1e-6)" % (warned, out["nondecaying_residual"]))
    if not (warned and out["nondecaying_residual"] > 1e-6):
        raise RuntimeError("the self-check missed the non-decaying kernel")

    n = n_debug
    x, y, yerr, kernel = smooth_dataset(n)
    gp = gtt.GP(kernel, solver=gtt.HODLRSolver, min_size=128, rank=12,
                debug=True, grad_mode="hutchinson", verbose=True,
                device=device, dtype=torch.float64)
    t0 = time.perf_counter()
    gp.compute(x, yerr)
    sync(device)
    out["debug_compute_s"] = time.perf_counter() - t0
    out["compression_error"] = gp.solver.compression_error
    t0 = time.perf_counter()
    gp.grad_log_likelihood(y)
    sync(device)
    out["debug_grad_s"] = time.perf_counter() - t0
    rep = gp.debug_gradient
    log("debug n=%d f64: compute with the check %.3f s, compression error "
        "%.3e (limit 1e-6); gradient with the dense comparison %.3f s, "
        "max|exact - estimated| %s"
        % (n, out["debug_compute_s"], out["compression_error"],
           out["debug_grad_s"],
           None if rep is None else "%.4f" % rep["max_abs_delta"]))
    if not (out["compression_error"] is not None
            and out["compression_error"] < 1e-6 and rep is not None):
        raise RuntimeError("debug=True did not report its errors")
    out["debug_max_abs_delta"] = rep["max_abs_delta"]
    del gp

    x, y, yerr, kernel = smooth_dataset(n_knn)
    gp = gtt.GP(kernel, solver=gtt.HODLRSolver, min_size=128, rank=12,
                knn=8, device=device, dtype=torch.float32)
    t0 = time.perf_counter()
    gp.compute(x, yerr)
    ll = gp.log_likelihood(y)
    sync(device)
    out["knn_s"] = time.perf_counter() - t0
    log("knn=8 f32: compute + log_likelihood %.3f s" % out["knn_s"])
    out["knn_anchor_rel"] = check_anchor("knn=8 f32 GP.log_likelihood", ll,
                                         ANCHOR_F32, n_knn)
    return out


def lcm_dataset(n_total):
    """``examples/multioutput.py::at_scale``'s model and data, from the
    port's twin (``george_tpu_torch.examples.multioutput``): x (coordinate,
    task id), y, yerr, kernel."""
    from george_tpu_torch.examples.multioutput import at_scale_problem

    return at_scale_problem(n_total)


def phase_lcm(device, n):
    """The multi-output LCM model at scale through the hierarchical solver
    (``min_size`` 128), three runs at ``n``: the example's rank 48 in
    float64 and in float32, and rank 96 with two refinement steps in
    float64.

    At n = 1e5 the example's data is ten times denser than at its own
    size (1e4), and its covariance (noise variance 0.01 under ~2000 points
    per correlation length) is so ill-conditioned that rank 48's
    compression error moves the task-1 prediction past the example's bound
    (an RMSE of 0.05) while its solves stay accurate, and float32 breaks
    the SMW cascade. So the example's accuracy is held at rank 96 with
    refinement (RMSE below 0.05, self-check residual below 1e-6); rank 48's
    numbers are printed; and a float32 result must be accurate (within
    2e-3 of float64) or flagged by the self-check (residual over 1e-2),
    never silently wrong."""
    import warnings

    import torch
    import george_tpu_torch as gtt

    x, y, yerr, kernel = lcm_dataset(n)
    t = np.linspace(5, 195, 200)
    t1 = np.stack([t, np.ones_like(t)], axis=1)
    out = {}
    runs = (("float64_rank48", torch.float64, 48, "auto"),
            ("float32_rank48", torch.float32, 48, "auto"),
            ("float64_rank96_refine2", torch.float64, 96, 2))
    for name, dtype, rank, refine in runs:
        gtt.HODLRSolver._checked_configs.clear()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            gp = gtt.GP(kernel, solver=gtt.HODLRSolver, min_size=128,
                        rank=rank, refine_steps=refine, verbose=True,
                        device=device, dtype=dtype)
            sync(device)
            t0 = time.perf_counter()
            gp.compute(x, yerr)
            sync(device)
            compute_s = time.perf_counter() - t0
        flagged = any("self-check" in str(w.message) for w in caught)
        t0 = time.perf_counter()
        ll = gp.log_likelihood(y)
        sync(device)
        ll_s = time.perf_counter() - t0
        mu1 = gp.predict(y, t1, return_cov=False)
        rmse = float(np.sqrt(np.mean((mu1 - 0.6 * np.sin(0.3 * t)) ** 2)))
        st = gp.solver._struct
        out[name] = {"ll": ll, "compute_s": compute_s,
                     "log_likelihood_s": ll_s, "rmse_task1": rmse,
                     "factor_residual": gp.solver.factor_residual,
                     "self_check_warned": flagged}
        log("lcm n=%d %s (L=%d, %d leaves of %d, rank %d, refine %s): "
            "compute %.3f s, log_likelihood %.3f s, ll %.6f, task-1 "
            "prediction RMSE %.4f, self-check residual %.3e (warned %s)"
            % (n, name, st.L, st.n_pad // st.m, st.m, st.rank, refine,
               compute_s, ll_s, ll, rmse, gp.solver.factor_residual,
               flagged))
        if not np.isfinite(ll) or gp.solver.factor_residual is None:
            raise RuntimeError("lcm %s: no finite likelihood or no "
                               "self-check" % name)
        del gp
    ok = out["float64_rank96_refine2"]
    if not (ok["rmse_task1"] < 0.05 and ok["factor_residual"] <= 1e-6):
        raise RuntimeError("lcm: rank 96 misses the example's RMSE bound")
    f32 = out["float32_rank48"]
    out["ll_rel_f32_vs_f64"] = abs(f32["ll"] - out["float64_rank48"]["ll"]
                                   ) / abs(out["float64_rank48"]["ll"])
    log("lcm: f32 log-likelihood %.3e from f64 at rank 48; f32 flagged by "
        "the self-check %s (an f32 result must be within 2e-3 or flagged)"
        % (out["ll_rel_f32_vs_f64"], f32["factor_residual"] > 1e-2))
    if not (out["ll_rel_f32_vs_f64"] <= 2e-3
            or (f32["factor_residual"] > 1e-2 and f32["self_check_warned"])):
        raise RuntimeError("lcm: f32 silently off f64")
    return out


# ---------------------------------------------------------------------------
# phase 16: the strong-admissibility H-matrix solver
# ---------------------------------------------------------------------------

def hmatrix_dataset(n, seed):
    """benchmarks/bench_hmatrix.py's ``_dataset``, same numpy stream: 2-D
    points on a square whose side grows like sqrt(n), a smooth field plus
    noise 0.1; x, y, yerr."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 12.0 * np.sqrt(n / 2000.0), (n, 2))
    truth = np.sin(x[:, 0]) * np.cos(0.7 * x[:, 1])
    y = truth + 0.1 * rng.standard_normal(n)
    yerr = 0.1 * np.ones(n)
    return x, y, yerr


def hmatrix_kernel():
    from george_tpu_torch import kernels

    return 1.0 * kernels.ExpSquaredKernel([1.5, 1.5], ndim=2)


def hmatrix_gp(device, dtype, **kw):
    """bench_hmatrix's solver: min_size 64, rank 16."""
    import george_tpu_torch as gtt

    kw = dict(dict(min_size=64, rank=16), **kw)
    return gtt.GP(hmatrix_kernel(), solver=gtt.HMatrixSolver, device=device,
                  dtype=dtype, **kw)


def dense_gp(kernel, x, yerr, device):
    """The port's dense float64 solver on the card."""
    import torch
    import george_tpu_torch as gtt

    gp = gtt.GP(kernel, solver=gtt.BasicSolver, device=device,
                dtype=torch.float64)
    gp.compute(x, yerr)
    return gp


def _gate(label, value, limit):
    log("%s: %.3e (limit %.0e)" % (label, value, limit))
    if not value <= limit:
        raise RuntimeError("%s: %.3e over %.0e" % (label, value, limit))
    return value


def phase_hmatrix_accuracy(device, n=4000):
    """(a) bench_hmatrix's truth size: the likelihood in float64 and float32
    against the recorded CPU-float64 dense truth and the port's dense
    float64 solver on the card."""
    import torch

    x, y, yerr = hmatrix_dataset(n, 3)
    ll_dense = dense_gp(hmatrix_kernel(), x, yerr, device).log_likelihood(y)
    out = {"ll_dense": ll_dense,
           "dense_vs_truth_rel": abs(ll_dense - HM_TRUTH_4000)
           / abs(HM_TRUTH_4000)}
    log("hmatrix (a) n=%d: dense f64 on the card %.10f, recorded CPU truth "
        "%.10f, rel %.3e" % (n, ll_dense, HM_TRUTH_4000,
                             out["dense_vs_truth_rel"]))
    for dtype, limit in ((torch.float64, 1e-4), (torch.float32, 1e-3)):
        name = str(dtype).split(".")[-1]
        gp = hmatrix_gp(device, dtype)
        gp.compute(x, yerr)
        ll = gp.log_likelihood(y)
        s = gp.solver
        out[name] = {"ll": ll, "cg_iters": s.last_cg_iters,
                     "nystrom_rank": s.nystrom_rank_effective}
        log("hmatrix (a) %s: ll %.10f, CG iterations %d, Nystrom rank %d"
            % (name, ll, s.last_cg_iters, s.nystrom_rank_effective))
        out[name]["rel_truth"] = _gate(
            "hmatrix (a) %s rel err vs the recorded truth" % name,
            abs(ll - HM_TRUTH_4000) / abs(HM_TRUTH_4000), limit)
        out[name]["rel_dense"] = _gate(
            "hmatrix (a) %s rel err vs the dense solver" % name,
            abs(ll - ll_dense) / abs(ll_dense), limit)
    return out


def phase_hmatrix_16k(device, n=16000, sqrt_steps=HM_SQRT_STEPS):
    """(b) bench_hmatrix --truth-n 16000: likelihoods and the gradient
    against the dense float64 ones on the card, GP.sample, apply_sqrt
    against the matvec, and log_prob over 2 chains under the samplers'
    batched evaluator."""
    import torch
    from george_tpu_torch.sampling import hmc

    x, y, yerr = hmatrix_dataset(n, 3)
    t0 = time.perf_counter()
    gpd = dense_gp(hmatrix_kernel(), x, yerr, device)
    ll_dense = gpd.log_likelihood(y)
    g_dense = gpd.grad_log_likelihood(y)
    sync(device)
    out = {"dense_s": time.perf_counter() - t0, "ll_dense": ll_dense,
           "grad_dense": g_dense.tolist()}
    del gpd
    log("hmatrix (b) n=%d: dense f64 ll %.10f and gradient %s on the card "
        "(%.3f s)" % (n, ll_dense, np.array2string(g_dense),
                      out["dense_s"]))
    out["dense_vs_recorded"] = _gate(
        "hmatrix (b) dense ll vs the recorded 11762.457",
        abs(ll_dense - HM_TRUTH_16000) / abs(HM_TRUTH_16000), 1e-6)
    scale = float(np.abs(g_dense).max())
    for dtype, limit in ((torch.float64, 1e-4), (torch.float32, 1e-3)):
        name = str(dtype).split(".")[-1]
        gp = hmatrix_gp(device, dtype)
        sync(device)
        t0 = time.perf_counter()
        gp.compute(x, yerr)
        ll = gp.log_likelihood(y)
        sync(device)
        res = {"compute_ll_s": time.perf_counter() - t0, "ll": ll,
               "cg_iters": gp.solver.last_cg_iters}
        res["rel_dense"] = _gate(
            "hmatrix (b) %s ll %.6f (compute + ll %.3f s, CG %d) rel err vs "
            "dense" % (name, ll, res["compute_ll_s"], res["cg_iters"]),
            abs(ll - ll_dense) / abs(ll_dense), limit)
        if dtype == torch.float64:
            np.random.seed(0)
            draws = gp.sample(size=2)
            if draws.shape != (2, n) or not np.all(np.isfinite(draws)):
                raise RuntimeError("hmatrix (b): GP.sample gave %s"
                                   % (draws.shape,))
            v = np.random.default_rng(21).standard_normal(n)
            s = gp.solver
            t0 = time.perf_counter()
            SSv = s.apply_sqrt(s.apply_sqrt(v, num_steps=sqrt_steps),
                               num_steps=sqrt_steps)
            res["apply_sqrt_twice_s"] = time.perf_counter() - t0
            Kv = s.apply_forward(v)
            res["sqrt_rel"] = _gate(
                "hmatrix (b) f64 apply_sqrt twice (%d Lanczos steps, %.3f s)"
                " vs apply_forward, max|d| of max|Kv|"
                % (sqrt_steps, res["apply_sqrt_twice_s"]),
                float(np.abs(SSv - Kv).max() / np.abs(Kv).max()), 1e-5)
        gps = {True: gp}
        gph = hmatrix_gp(device, dtype, num_probes=32)
        gph.compute(x, yerr)
        sync(device)
        t0 = time.perf_counter()
        g = gph.grad_log_likelihood(y)
        res["grad_s"] = time.perf_counter() - t0
        res["grad"] = g.tolist()
        res["grad_cg_iters"] = gph.solver.last_cg_iters
        res["deflation_rank"] = int(
            gph.solver._grad_deflation_basis().shape[1])
        res["grad_rel"] = _gate(
            "hmatrix (b) %s Hutchinson gradient (32 probes, deflation rank "
            "%d, CG %d, %.3f s) %s vs dense, max|d| / max|g|"
            % (name, res["deflation_rank"], res["grad_cg_iters"],
               res["grad_s"], np.array2string(g)),
            float(np.abs(g - g_dense).max()) / scale, 0.1)
        del gph
        # the fused likelihood's reverse-mode gradient (the SLQ adjoint and
        # the implicit solve adjoint) at the computed parameters, on the
        # near field stored and on the fly
        gps[False] = hmatrix_gp(device, dtype, store_near=False)
        gps[False].compute(x, yerr)
        for store in (True, False):
            key = "log_prob_grad_" + ("stored" if store else "on_the_fly")
            gpl = gps.pop(store)
            if (gpl.solver._near is not None) != store:
                raise RuntimeError("hmatrix (b): the near field is not %s"
                                   % ("stored" if store else "on the fly"))
            lp = gpl.log_prob_fn(x, y, yerr, gate_prior=False)
            th = torch.as_tensor(gpl.get_parameter_vector(), device=device,
                                 dtype=dtype)
            torch.cuda.reset_peak_memory_stats()
            sync(device)
            t0 = time.perf_counter()
            gl, _ = torch.func.grad_and_value(lp)(th)
            sync(device)
            gl = gl.double().cpu().numpy()
            res[key] = {"seconds": time.perf_counter() - t0,
                        "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                        "grad": gl.tolist()}
            res[key]["rel"] = _gate(
                "hmatrix (b) %s log_prob_fn reverse-mode gradient, near "
                "field %s (%.3f s, peak %.3f GB) %s vs dense, max|d| / "
                "max|g|"
                % (name, "stored" if store else "on the fly",
                   res[key]["seconds"], res[key]["peak_gb"],
                   np.array2string(gl)),
                float(np.abs(gl - g_dense).max()) / scale, 0.1)
            del gpl, lp
            torch.cuda.empty_cache()
        out[name] = res

    # log_prob_fn over 2 chains, float32, through the samplers' evaluator
    gp = hmatrix_gp(device, torch.float32)
    gp.compute(x, yerr)
    log_prob = gp.log_prob_fn(x, y, yerr, gate_prior=False)
    truth = gp.get_parameter_vector()
    thetas = torch.as_tensor(
        truth[None, :] + 0.01 * np.random.default_rng(5).standard_normal(
            (2, len(truth))), device=device, dtype=torch.float32)
    value_and_grad = hmc._make_value_and_grad(log_prob)
    torch.cuda.reset_peak_memory_stats()
    sync(device)
    t0 = time.perf_counter()
    lp, g = value_and_grad(thetas)
    sync(device)
    out["chains_eval_s"] = time.perf_counter() - t0
    out["chains_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    single = torch.func.grad_and_value(log_prob)
    rels = []
    for c in range(2):
        g1, v1 = single(thetas[c])
        r = {"value": abs(float(lp[c]) - float(v1)) / abs(float(v1)),
             "grad": float((g[c] - g1).abs().max())
             / float(g1.abs().max())}
        rels.append(r)
        log("hmatrix (b) chain %d: batched vs unbatched f32 value %.6f, rel "
            "%.3e (limit 1e-5); gradient %s, max|d| %.3e of max|g| (limit "
            "1e-3)" % (c, float(v1), r["value"],
                       np.array2string(g1.cpu().numpy()), r["grad"]))
    out["chains_rel"] = rels
    # the fused likelihood and the solver's own share the SLQ probes and
    # the whitener, so they part only by float32 rounding
    out["log_prob_vs_host"] = abs(
        float(log_prob(torch.as_tensor(truth, device=device,
                                       dtype=torch.float32)))
        - gp.log_likelihood(y)) / abs(ll_dense)
    log("hmatrix (b) log_prob over 2 chains, f32: %.3f s per batched value "
        "and gradient, peak device memory %.3f GB; log_prob at "
        "compute-theta vs the host likelihood, rel %.3e (limit 1e-6)"
        % (out["chains_eval_s"], out["chains_peak_gb"],
           out["log_prob_vs_host"]))
    if not all(r["value"] <= 1e-5 and r["grad"] <= 1e-3 for r in rels):
        raise RuntimeError("hmatrix (b): batched and unbatched chains "
                           "disagree")
    if not out["log_prob_vs_host"] <= 1e-6:
        raise RuntimeError("hmatrix (b): log_prob at compute-theta is off "
                           "the host likelihood")

    # the same evaluation where the near field is not stored: reverse mode
    # through the on-the-fly near field, its blocks evaluated again
    gpf = hmatrix_gp(device, torch.float32, store_near=False)
    gpf.compute(x, yerr)
    log_prob_f = gpf.log_prob_fn(x, y, yerr, gate_prior=False)
    del gp, log_prob, value_and_grad
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    sync(device)
    t0 = time.perf_counter()
    g_f, v_f = torch.func.grad_and_value(log_prob_f)(thetas[0])
    sync(device)
    out["on_the_fly_eval_s"] = time.perf_counter() - t0
    out["on_the_fly_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["on_the_fly_grad_rel"] = float((g_f - g[0]).abs().max()
                                       / g[0].abs().max())
    log("hmatrix (b) log_prob value and gradient with the near field on the "
        "fly, f32: %.3f s, peak device memory %.3f GB; gradient vs the "
        "stored near field's, max|d| %.3e of max|g| (limit 1e-3)"
        % (out["on_the_fly_eval_s"], out["on_the_fly_peak_gb"],
           out["on_the_fly_grad_rel"]))
    if not out["on_the_fly_grad_rel"] <= 1e-3:
        raise RuntimeError("hmatrix (b): the on-the-fly near field's "
                           "gradient is off the stored one's")
    return out


HM_STAGES = ("hmatrix.traversal", "hmatrix.far_pivots", "hmatrix.compress",
             "hmatrix.near", "hmatrix.nystrom_fps", "hmatrix.nystrom_columns",
             "hmatrix.nystrom_cholqr", "hmatrix.nystrom_eigh",
             "hmatrix.whitener", "hmatrix.slq", "hmatrix.compute")


def phase_hmatrix_headline(device, n, dtype):
    """(c) bench_hmatrix --n 100000: compute with its stage breakdown (the
    solver's ``diagnostics`` spans, each closed by a synchronization), the
    likelihood first and repeated, dot_solve, peak memory, the near field's
    bytes, and a profile of one dot_solve cut to ``HM_PROFILE_ITERS`` CG
    iterations.

    float32 times one repeated likelihood and the best of 2 ``dot_solve``
    calls, float64 the first likelihood only (a float64 solve here takes
    138 CG iterations of 106 ms on an H100): bench_hmatrix's 3 repeated
    likelihoods and 5 ``dot_solve`` calls repeat one solve, and with
    phase 16 (f) they would take the script past its time limit."""
    import torch
    from george_tpu_torch import diagnostics

    name = str(dtype).split(".")[-1]
    full = dtype == torch.float32
    x, y, yerr = hmatrix_dataset(n, 7)
    gp = hmatrix_gp(device, dtype)
    diagnostics.reset()
    torch.cuda.reset_peak_memory_stats()
    sync(device)
    t0 = time.perf_counter()
    gp.compute(x, yerr)
    sync(device)
    out = {"compute_s": time.perf_counter() - t0}
    rep = diagnostics.report()
    out["stages_s"] = {k.split(".")[1]: rep[k]["total_s"]
                       for k in HM_STAGES if k in rep}
    s = gp.solver
    hs = s._hs
    out.update({"resident_gb_after_compute":
                torch.cuda.memory_allocated() / 1e9,
                "near_bytes": s.near_bytes, "near_stored": s._near is not None,
                "nystrom_rank": s.nystrom_rank_effective,
                "leaves": [hs.B, hs.m], "near_slots": hs.near_nbr.shape[1],
                "n_near": hs.n_near, "n_far": hs.n_far,
                "far_ranks": [lev["c"] for lev in hs.far]})
    log("hmatrix (c) %s n=%d: compute %.3f s; stages %s" % (
        name, n, out["compute_s"], json.dumps(out["stages_s"])))
    log("hmatrix (c) %s: %d leaves of %d, %d near slots, %d near and %d far "
        "pairs, far ranks %s, near field %.3f GB (%s), Nystrom rank %d"
        % (name, hs.B, hs.m, out["near_slots"], hs.n_near, hs.n_far,
           out["far_ranks"], s.near_bytes / 1e9,
           "stored" if out["near_stored"] else "evaluated per matvec",
           out["nystrom_rank"]))
    t0 = time.perf_counter()
    ll = gp.log_likelihood(y)
    out["loglike_s_first"] = time.perf_counter() - t0
    out["ll"] = ll
    out["loglike_s_repeat"] = out["solve_s"] = None
    if full:
        t0 = time.perf_counter()
        gp.log_likelihood(y + 1e-6)
        out["loglike_s_repeat"] = time.perf_counter() - t0
        times = []
        for k in range(2):
            t0 = time.perf_counter()
            s.dot_solve(y + 1e-6 * k)
            times.append(time.perf_counter() - t0)
        out["solve_s"] = min(times)
    out["cg_iters"] = s.last_cg_iters
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log("hmatrix (c) %s: ll %.6f, log_likelihood first %.4f s, repeated "
        "%s, dot_solve %s (best of 2), CG iterations %d, peak device "
        "memory %.3f GB"
        % (name, ll, out["loglike_s_first"],
           _secs(out["loglike_s_repeat"]), _secs(out["solve_s"]),
           out["cg_iters"], out["peak_gb"]))
    if not np.isfinite(ll):
        raise RuntimeError("hmatrix (c) %s: non-finite likelihood" % name)
    # the profile window: one dot_solve cut to HM_PROFILE_ITERS CG
    # iterations, beside the same cut solve's unprofiled time (processing
    # the 2e5 device operations of a whole float32 solve took the
    # profiler 114 s on an H100 machine's host)
    maxiter = s.maxiter
    s.maxiter = HM_PROFILE_ITERS
    try:
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            s.dot_solve(y)
            times.append(time.perf_counter() - t0)
        out["cut_solve_ms"] = min(times) * 1e3
        out["profile"] = profile_calls(
            [lambda: s.dot_solve(y)], out["cut_solve_ms"],
            "hmatrix (c) %s, one dot_solve cut to %d CG iterations"
            % (name, HM_PROFILE_ITERS))
    finally:
        s.maxiter = maxiter
    return out


def _secs(v):
    return "not run" if v is None else "%.4f s" % v


def memory_trace(label, device, evaluate):
    """``evaluate()`` under ``diagnostics.memory_trace``: the device memory
    of each stage of the H-matrix likelihood (``hmatrix.ll.parts``, the
    forward PCG ``hmatrix.ll.pcg`` and SLQ ``hmatrix.ll.slq``,
    ``hmatrix.quad.backward``, ``hmatrix.logdet.backward``,
    ``hmatrix.compress.backward`` and ``hmatrix.near.backward``) and of
    the stages ``evaluate`` opens
    itself, one line each, in the order they close: bytes allocated at its
    start and end and the peak while it ran, nested stages included. An
    out-of-memory error is printed with the stages that closed before it
    and raised. Returns ``(evaluate(), records)``."""
    import torch
    from george_tpu_torch import diagnostics

    torch.cuda.empty_cache()
    with diagnostics.memory_trace(device) as rec:
        try:
            return evaluate(), rec
        finally:
            for r in rec:
                log("%s memory: %-60s %8.3f s  start %s  end %s  peak %s"
                    % (label, r["stage"], r["seconds"], _gb(r["start_gb"]),
                       _gb(r["end_gb"]), _gb(r["peak_gb"])))


def _gb(v):
    return "not measured" if v is None else "%.3f GB" % v


def _staged_grad_and_value(log_prob, theta):
    """``torch.func.grad_and_value(log_prob)(theta)``, as ``minimize`` and
    the samplers call it, in a ``grad_and_value`` stage with the forward
    pass in a ``forward`` stage inside it: what the backward pass runs
    outside the solver's own stages (in plain autograd, the far
    compression's graph) shows in ``grad_and_value``'s peak."""
    import torch
    from george_tpu_torch import diagnostics

    def staged(th):
        with diagnostics.memory_stage("forward"):
            return log_prob(th)

    with diagnostics.memory_stage("grad_and_value"):
        return torch.func.grad_and_value(staged)(theta)


def _plain_parts(solver):
    """Route ``solver``'s fused-likelihood parts through plain autograd
    over ``hmatrix_compress`` and ``hmatrix_near_values`` (the outer graph
    keeps every intermediate of the far compression and of the stored near
    field, and the log-determinant's adjoint builds them a second time):
    the layout before they were rematerialized, for
    ``--hmatrix-memory``."""
    from george_tpu_torch.solvers import hmatrix as HM

    def parts(theta):
        far = HM.hmatrix_compress(solver.kernel.pair_fn, theta,
                                  solver._xpad, solver._valid, solver._hs,
                                  ridge_floor=solver.tol_abs)
        out = [t for cq in far for t in cq]
        if solver._near is not None:
            out.extend(HM.hmatrix_near_values(solver.kernel.pair_fn, theta,
                                              solver._xpad, solver._valid,
                                              solver._hs))
        return tuple(out)

    solver._parts = parts


def hmatrix_memory(device="cuda"):
    """``--hmatrix-memory``: the per-stage device memory of one
    ``log_prob_fn`` value and gradient through ``torch.func.grad_and_value``
    (float32, at the computed parameters) with the far factors and the
    stored near field rematerialized (``_FarFactors``, ``_NearValues``:
    the solver as it is) and through plain autograd (``_plain_parts``): at
    bench_hmatrix's n = 16000 with the near field stored and on the fly,
    then at n = 1e5 (on the fly). An evaluation that runs out of memory is
    printed with the stages that closed before it. One evaluation at
    n = 16000 runs first, untraced, so that no trace pays the process's
    first-call costs."""
    import torch

    smi = phase_device()
    phase_build()
    x, y, yerr = hmatrix_dataset(16000, 3)
    gp = hmatrix_gp(device, torch.float32)
    gp.compute(x, yerr)
    torch.func.grad_and_value(gp.log_prob_fn(x, y, yerr, gate_prior=False))(
        torch.as_tensor(gp.get_parameter_vector(), device=device,
                        dtype=torch.float32))
    del gp
    out = {}
    for n, seed, stores in ((16000, 3, (True, False)), (N_HM, 7, (False,))):
        x, y, yerr = hmatrix_dataset(n, seed)
        for store in stores:
            gp = hmatrix_gp(device, torch.float32, store_near=store)
            gp.compute(x, yerr)
            theta = torch.as_tensor(gp.get_parameter_vector(),
                                    device=device, dtype=torch.float32)
            for variant in ("rematerialized", "plain autograd"):
                if variant == "plain autograd":
                    _plain_parts(gp.solver)
                lp = gp.log_prob_fn(x, y, yerr, gate_prior=False)
                key = "n=%d %s %s" % (
                    n, "stored" if store else "on the fly", variant)
                sync(device)
                t0 = time.perf_counter()
                try:
                    (g, v), rec = memory_trace(
                        key, device,
                        lambda: _staged_grad_and_value(lp, theta))
                    res = {"seconds": time.perf_counter() - t0,
                           "value": float(v),
                           "grad": g.double().cpu().numpy().tolist()}
                except torch.cuda.OutOfMemoryError as e:
                    res = {"out_of_memory": str(e).splitlines()[0]}
                out[key] = res
                log("hmatrix memory, %s on %s: %s" % (key, smi,
                                                       json.dumps(res)))
                del lp
                torch.cuda.empty_cache()
            del gp
            torch.cuda.empty_cache()
    log(smi)
    print(json.dumps({"hmatrix_memory": out, "device": smi}), flush=True)


def _recording_minimize():
    """``scipy.optimize.minimize`` wrapped to record each value of the
    objective it is handed: ``(values, restore)``."""
    import scipy.optimize

    values = []
    original = scipy.optimize.minimize

    def recording(fun, x0, **kwargs):
        def wrapped(v):
            f, g = fun(v)
            values.append(float(f))
            return f, g

        return original(wrapped, x0, **kwargs)

    scipy.optimize.minimize = recording

    def restore():
        scipy.optimize.minimize = original

    return values, restore


def phase_hmatrix_fit(device, card, n=N_HM):
    """(f) the fit path at bench_hmatrix's n = 1e5, float32, on (c)'s
    dataset (seed 7) and solver, 32 probes: (1) ``GP.grad_log_likelihood``
    (the deflated Hutchinson estimator, one ``jvp`` per parameter); (2) one
    unbatched ``log_prob_fn`` value and gradient at the computed
    parameters with its per-stage memory trace, the value against
    ``gp.log_likelihood`` (1e-6) and the gradient against (1) (0.1 of
    max|g|); (3) two chains at the computed parameters plus 0.01 noise
    through the samplers' batched evaluator, each against its unbatched
    evaluation (1e-5 in the value, 1e-3 of max|g| in the gradient); (4)
    ``minimize`` for 2 iterations, ending finite and no higher than it
    started. Every time is printed beside ``card``."""
    import torch
    from george_tpu_torch.sampling import hmc, minimize

    x, y, yerr = hmatrix_dataset(n, 7)
    gp = hmatrix_gp(device, torch.float32, num_probes=32)
    sync(device)
    t0 = time.perf_counter()
    gp.compute(x, yerr)
    sync(device)
    out = {"compute_s": time.perf_counter() - t0}
    s = gp.solver

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    g_h = gp.grad_log_likelihood(y)
    sync(device)
    out["hutchinson"] = {
        "seconds": time.perf_counter() - t0, "grad": g_h.tolist(),
        "cg_iters": s.last_cg_iters,
        "deflation_rank": int(s._grad_deflation_basis().shape[1]),
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    log("hmatrix (f) n=%d f32 on %s: grad_log_likelihood %s (32 probes, "
        "deflation rank %d, CG %d) %.3f s, peak %.3f GB"
        % (n, card, np.array2string(g_h),
           out["hutchinson"]["deflation_rank"],
           out["hutchinson"]["cg_iters"], out["hutchinson"]["seconds"],
           out["hutchinson"]["peak_gb"]))
    scale = float(np.abs(g_h).max())

    ll = gp.log_likelihood(y)
    log_prob = gp.log_prob_fn(x, y, yerr, gate_prior=False)
    truth = gp.get_parameter_vector()
    theta = torch.as_tensor(truth, device=device, dtype=torch.float32)
    single = torch.func.grad_and_value(log_prob)
    torch.cuda.reset_peak_memory_stats()
    sync(device)
    t0 = time.perf_counter()
    (g1, v1), rec = memory_trace(
        "hmatrix (f)", device, lambda: _staged_grad_and_value(log_prob,
                                                              theta))
    sync(device)
    g1 = g1.double().cpu().numpy()
    ev = {"seconds": time.perf_counter() - t0, "value": float(v1),
          "grad": g1.tolist(), "peak_gb": rec[-1]["peak_gb"],
          "stages": rec}
    ev["value_rel"] = _gate(
        "hmatrix (f) log_prob_fn value %.6f vs gp.log_likelihood %.6f, rel"
        % (ev["value"], ll), abs(ev["value"] - ll) / abs(ll), 1e-6)
    ev["grad_rel"] = _gate(
        "hmatrix (f) log_prob_fn reverse-mode gradient %s (%.3f s, peak "
        "%s on %s) vs grad_log_likelihood, max|d| / max|g|"
        % (np.array2string(g1), ev["seconds"], _gb(ev["peak_gb"]), card),
        float(np.abs(g1 - g_h).max()) / scale, 0.1)
    out["value_and_grad"] = ev

    thetas = torch.as_tensor(
        truth[None, :] + 0.01 * np.random.default_rng(5).standard_normal(
            (2, len(truth))), device=device, dtype=torch.float32)
    value_and_grad = hmc._make_value_and_grad(log_prob)
    torch.cuda.reset_peak_memory_stats()
    sync(device)
    t0 = time.perf_counter()
    lp, g = value_and_grad(thetas)
    sync(device)
    ch = {"seconds": time.perf_counter() - t0,
          "peak_gb": torch.cuda.max_memory_allocated() / 1e9, "rel": []}
    for c in range(2):
        gc, vc = single(thetas[c])
        r = {"value": abs(float(lp[c]) - float(vc)) / abs(float(vc)),
             "grad": float((g[c] - gc).abs().max() / gc.abs().max())}
        ch["rel"].append(r)
        log("hmatrix (f) chain %d: batched vs unbatched value %.6f, rel "
            "%.3e (limit 1e-5); gradient %s, max|d| %.3e of max|g| (limit "
            "1e-3)" % (c, float(vc), r["value"],
                       np.array2string(gc.cpu().numpy()), r["grad"]))
    log("hmatrix (f) 2 chains through the samplers' batched evaluator on "
        "%s: %.3f s, peak %.3f GB" % (card, ch["seconds"], ch["peak_gb"]))
    if not all(r["value"] <= 1e-5 and r["grad"] <= 1e-3 for r in ch["rel"]):
        raise RuntimeError("hmatrix (f): batched and unbatched chains "
                           "disagree")
    out["chains"] = ch
    del value_and_grad, log_prob, single

    values, restore = _recording_minimize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        res = minimize(gp, y, options={"maxiter": 2})
    finally:
        restore()
    sync(device)
    mn = {"seconds": time.perf_counter() - t0, "evaluations": len(values),
          "start": truth.tolist(), "end": np.asarray(res.x).tolist(),
          "start_objective": values[0], "end_objective": float(res.fun),
          "nit": int(res.nit),
          "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    log("hmatrix (f) minimize(maxiter=2) on %s: %d evaluations, %.3f s, "
        "peak %.3f GB; parameters %s -> %s; objective %.6f -> %.6f"
        % (card, mn["evaluations"], mn["seconds"], mn["peak_gb"],
           np.array2string(np.asarray(mn["start"])),
           np.array2string(np.asarray(mn["end"])), mn["start_objective"],
           mn["end_objective"]))
    if not (np.isfinite(mn["end_objective"])
            and mn["end_objective"] <= mn["start_objective"]):
        raise RuntimeError("hmatrix (f): minimize ended at %r from %r"
                           % (mn["end_objective"], mn["start_objective"]))
    out["minimize"] = mn
    return out


def phase_hmatrix_spatial(device, n=2000):
    """(d) examples/spatial.py at its n = 2000, float64, through the port's
    twin (``george_tpu_torch.examples.spatial.main``, whose asserts hold
    the prediction RMSE and coverage and the strong solver's likelihood
    error against the dense one beside the weak HODLR solver's at the same
    rank, which launches the leaf kernel)."""
    import torch
    from george_tpu_torch.examples import spatial

    out = spatial.main(n, device=device, dtype=torch.float64)
    if tuple(out["weak_leaves"]) != HM_WEAK_LEAVES:
        raise RuntimeError("hmatrix (d): the weak solver's leaves %s are not "
                           "the kernel phase's %s"
                           % (out["weak_leaves"], HM_WEAK_LEAVES))
    log("hmatrix (d) spatial n=%d f64: ll %.6f, dense %.6f, weak %.6f; RMSE "
        "%.4f (limit 0.1), 2-sigma coverage %.3f (limit 0.9); rel err strong "
        "%.3e (limit 5e-4), weak %.3e (strong must be < 0.1 x weak)"
        % (n, out["ll"], out["ll_exact"], out["ll_weak"], out["rmse"],
           out["coverage"], out["err_strong"], out["err_weak"]))
    return out


def phase_hmatrix_sym_1d(device, n=20_000):
    """(e) the float64 1-D whitener (the weak symmetric HODLR cascade, its
    leaves through the leaf kernel) on the smooth dataset, against the
    dense float64 solver on the card."""
    import torch
    import george_tpu_torch as gtt
    from george_tpu_torch.ops import chol

    x, y, yerr, kernel = smooth_dataset(n)
    before = chol.chol_kernel_launches
    gp = gtt.GP(kernel, solver=gtt.HMatrixSolver, min_size=64,
                device=device, dtype=torch.float64)
    sync(device)
    t0 = time.perf_counter()
    gp.compute(x, yerr)
    ll = gp.log_likelihood(y)
    sync(device)
    s = gp.solver
    out = {"compute_ll_s": time.perf_counter() - t0, "ll": ll,
           "cg_iters": s.last_cg_iters,
           "whitener_leaves": [s._st.n_pad // s._st.m, s._st.m],
           "leaf_launches": chol.chol_kernel_launches - before}
    ll_dense = dense_gp(kernel, x, yerr, device).log_likelihood(y)
    out["ll_dense"] = ll_dense
    log("hmatrix (e) 1-D f64 n=%d: symmetric whitener over %d leaves of %d, "
        "compute + ll %.3f s, CG %d, leaf kernel launches %d"
        % (n, out["whitener_leaves"][0], out["whitener_leaves"][1],
           out["compute_ll_s"], out["cg_iters"], out["leaf_launches"]))
    out["rel_dense"] = _gate(
        "hmatrix (e) ll %.6f vs dense %.6f, rel err" % (ll, ll_dense),
        abs(ll - ll_dense) / abs(ll_dense), 1e-4)
    if out["leaf_launches"] <= 0:
        raise RuntimeError("hmatrix (e): the whitener never launched the "
                           "leaf kernel")
    if tuple(out["whitener_leaves"]) != HM_WHITENER_LEAVES:
        raise RuntimeError("hmatrix (e): the whitener's leaves %s are not "
                           "the kernel phase's %s"
                           % (out["whitener_leaves"], HM_WHITENER_LEAVES))
    return out


def phase_hmatrix(device, card):
    """Phase 16: (a) to (f); (c) float32 then float64 at n = 1e5, (f) the
    fit path at n = 1e5 after it, its times beside ``card``. Each
    part's seconds are in ``out["seconds"]``. The leaf kernel's launches
    are counted apart for (a) to (d), where only the weak HODLR comparison
    of (d) launches it, and for (e), the H-matrix solver's own whitener:
    ``out["launches"]``, each count set to 0 right before its part."""
    import torch
    from george_tpu_torch.ops import chol

    out, secs = {}, {}

    def run(key, fn, *args):
        t0 = time.perf_counter()
        result = fn(*args)
        secs[key] = time.perf_counter() - t0
        log("hmatrix (%s): %.3f s" % (key, secs[key]))
        torch.cuda.empty_cache()
        return result

    out["a"] = run("a", phase_hmatrix_accuracy, device)
    out["b"] = run("b", phase_hmatrix_16k, device)
    c = {}
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).split(".")[-1]
        c[name] = run("c " + name, phase_hmatrix_headline, device, N_HM,
                      dtype)
    c["f32_vs_f64_rel"] = _gate(
        "hmatrix (c) float32 ll vs float64 ll, rel",
        abs(c["float32"]["ll"] - c["float64"]["ll"])
        / abs(c["float64"]["ll"]), 1e-3)
    out["c"] = c
    out["f"] = run("f", phase_hmatrix_fit, device, card)
    out["d"] = run("d", phase_hmatrix_spatial, device)
    launches = {"weak_comparison": chol.chol_kernel_launches}
    chol.chol_kernel_launches = 0
    out["e"] = run("e", phase_hmatrix_sym_1d, device)
    launches["hmatrix_solver"] = chol.chol_kernel_launches
    out["launches"] = launches
    out["seconds"] = secs
    return out


def phase_checkpoint(samples, stats, seed):
    """The NUTS run's final state through ``checkpoint`` (the flat
    ``.npz``) and back, bit for bit; and ``diagnostics`` holding the
    solvers' compute spans of the phases above."""
    import tempfile

    from george_tpu_torch import checkpoint, diagnostics

    state = checkpoint.sampler_state(
        samples[-1], stats["logp"][-1], seed, step=len(samples),
        step_size=stats["step_size"], inv_mass=stats["inv_mass"],
        extras={"draws": samples, "logp": stats["logp"]})
    with tempfile.TemporaryDirectory() as tmp:
        path = checkpoint.save(os.path.join(tmp, "nuts_512"), state)
        size = os.path.getsize(path)
        back = checkpoint.restore_sampler(path)

    def same(a, b):
        b = b.detach().cpu().numpy()
        return a.dtype == b.dtype and np.array_equal(a, b)

    checks = {
        "draws": same(back["extras"]["draws"], samples),
        "log_probs": same(back["extras"]["logp"], stats["logp"]),
        "walkers": same(back["walkers"], samples[-1]),
        "step_size": same(back["step_size"], stats["step_size"]),
        "inv_mass": all(same(back["inv_mass"][k], stats["inv_mass"][k])
                        for k in ("sigma", "chol")),
        "seed": int(back["key"]) == seed,
    }
    rep = diagnostics.report()
    spans = {k: rep[k] for k in ("hodlr.compute", "basic.compute")
             if k in rep}
    log("checkpoint: %d draws of %d chains, %d bytes, back bit for bit: %s; "
        "diagnostics spans %s"
        % (samples.shape[0], samples.shape[1], size, checks,
           json.dumps(spans)))
    if not all(checks.values()) or len(spans) != 2:
        raise RuntimeError("checkpoint or diagnostics failed")
    return {"bytes": size, "checks": checks, "spans": spans}


# ---------------------------------------------------------------------------
# phase 17: parallel and the kernel API
# ---------------------------------------------------------------------------

# the ranks that share the one card, their rendezvous and join timeouts
P17_RANKS = 2
P17_RENDEZVOUS_S = 120
P17_JOIN_S = 900
# test points of sharded_predict per solver, the kernel API's CPU cut, and
# the H-matrix size of (c) (bench_hmatrix's seed-3 truth size)
P17_T_HODLR = 8192
# gp.predict on one rank is the reference of (c) and (e) at every k-th of
# each solver's test points: HODLR's is host numpy over 6.5 GB of cross
# covariances at all 8192, the sparse one a CG as long as a rank's
P17_REF_STRIDE = {"hodlr": 8, "sparse": 4, "hmatrix": 1}
P17_T_SPARSE = 512
P17_T_HM = 1024
P17_N_HM = 16_000
P17_API_CUT = 20_000
# the HODLR mesh run's prediction points (tests/test_parallel.py's check)
P17_T_MESH = 1000
# phase 11's NUTS options
P17_NUTS_KW = dict(max_depth=8, target_accept=0.8, dense_mass=True,
                   segment_size=8)
# (g): the rows apply_sqrt transports, the columns of the W^{-1}
# application, and GP.sample's numpy seed
P17_SYM_ROWS = 8
P17_SAMPLE_SEED = 31
# (h): the log_prob chains of the vmap, as shifts of the computed
# parameters (log_rc, log_M); and its size, a quarter of bench_dia's n at
# its density, for both dtypes and their one-rank references (at the full
# n its float64 value and gradient took 72.5 s a rank through gloo on an
# H100 and its float32 chains 75.0 s, and phase 16 (f) needed the room)
P17_LP_SHIFTS = [[0.0, 0.0], [0.05, -0.05]]
P17_N_LP = N_DIA // 4


def _max_rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def phase_kernel_api(device):
    """(a) The kernel-evaluation API on bench_dia's data (n = 2e5): the CSR
    ``get_value(x, nns=)`` and ``get_gradient(x, nns=)`` on the card in
    float64 and float32 against the sparse solver's own entry table on the
    same pairs and against the same API on the CPU at a 2e4 cut; then an
    amplitude times the compact-support kernel through ``SparseSolver``
    (direct, float64) at n = 2e5, and at the cut against the CPU."""
    import torch
    import george_tpu_torch as gtt
    from george_tpu_torch import kernels
    from george_tpu_torch.solvers import sparse as S

    x, _, y, yerr, kernel = bench_dia_dataset(N_DIA)
    n = len(x)
    out, full = {}, True
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-6)):
        name = str(dtype).split(".")[-1]
        sync(device)
        t0 = time.perf_counter()
        # the radius query in the float64 run; float32 reuses its pairs
        V = kernel.get_value(x, nns=full, device=device, dtype=dtype)
        full = kernel.nns_saved
        t_value = time.perf_counter() - t0
        t0 = time.perf_counter()
        G = kernel.get_gradient(x, nns=True, device=device, dtype=dtype)
        t_grad = time.perf_counter() - t0
        nbytes = V.data.nbytes + V.indices.nbytes + V.indptr.nbytes
        # the solver's entry table on the band of the same pairs: its
        # valid slots, row by row, are the CSR entries in order
        offsets, lo, hi = S.banded_offsets(*full)
        nbr, mask = S.banded_ell_tables(offsets, lo, hi, n)
        like = {"device": device, "dtype": dtype}
        mask_t = torch.as_tensor(mask, device=device)
        with torch.no_grad():
            vals = S.ell_values(
                kernel.pair_fn, kernel.theta.to(**like),
                torch.as_tensor(x[:, None]).to(**like),
                torch.as_tensor(nbr.astype(np.int64), device=device), mask_t)
            table = vals[mask_t].cpu().numpy()
        del vals
        err_table = _max_rel(V.data, table)
        xc = x[:P17_API_CUT]
        Vg = kernel.get_value(xc, nns=True, device=device, dtype=dtype)
        Vc = kernel.get_value(xc, nns=True, device="cpu", dtype=dtype)
        Gg = kernel.get_gradient(xc, nns=True, device=device, dtype=dtype)
        Gc = kernel.get_gradient(xc, nns=True, device="cpu", dtype=dtype)
        err_cpu = max([_max_rel(Vg.data, Vc.data)]
                      + [_max_rel(a.data, b.data) for a, b in zip(Gg, Gc)])
        same_pattern = (np.array_equal(Vg.indptr, Vc.indptr)
                        and np.array_equal(Vg.indices, Vc.indices))
        out[name] = {"nnz": int(V.nnz), "value_s": t_value,
                     "gradient_s": t_grad, "csr_bytes": int(nbytes),
                     "gradient_bytes": int(sum(g.data.nbytes for g in G)),
                     "vs_entry_table": err_table, "vs_cpu_cut": err_cpu}
        log("kernel api %s: get_value(nns=) %d pairs in %.3f s (%d CSR "
            "bytes), get_gradient(nns=) %d matrices in %.3f s; vs the "
            "solver's entry table %.3e, vs the CPU at n=%d %.3e (limits "
            "%.0e)" % (name, V.nnz, t_value, nbytes, len(G), t_grad,
                       err_table, P17_API_CUT, err_cpu, tol))
        if not (err_table <= tol and err_cpu <= tol and same_pattern
                and V.nnz == int(full[1][-1])):
            raise RuntimeError("kernel api %s disagrees" % name)
        del V, G, Vg, Vc, Gg, Gc
        kernel.nns_saved = full     # the cut's structure was the last
    kernel.nns_saved = None

    def scaled():
        return 2.0 * kernels.WendlandC2Kernel(
            log_rc=np.log(2.0), kernel_base=kernels.ExpSquaredKernel(1.0))

    sync(device)
    t0 = time.perf_counter()
    gp = gtt.GP(scaled(), solver=gtt.SparseSolver, direct=True,
                device=device, dtype=torch.float64)
    gp.compute(x, yerr)
    ll = gp.log_likelihood(y)
    sync(device)
    seconds = time.perf_counter() - t0
    if not np.isfinite(ll) or gp.solver._band_factors is None:
        raise RuntimeError("2.0 * WendlandC2 through SparseSolver failed")
    lls = []
    for dev in (device, "cpu"):
        g = gtt.GP(scaled(), solver=gtt.SparseSolver, direct=True,
                   device=dev, dtype=torch.float64)
        g.compute(x[:P17_API_CUT], yerr)
        lls.append(g.log_likelihood(y[:P17_API_CUT]))
    r = abs(lls[0] - lls[1]) / abs(lls[1])
    out["scaled_wendland"] = {"ll": ll, "seconds": seconds,
                              "cut_ll": lls, "cut_rel_vs_cpu": r}
    log("kernel api: 2.0 * WendlandC2 through SparseSolver (direct, "
        "float64) at n=%d: ll %.10f in %.3f s; at n=%d card %.12f vs CPU "
        "%.12f, rel %.3e (limit 1e-10)"
        % (n, ll, seconds, P17_API_CUT, lls[0], lls[1], r))
    if not r <= 1e-10:
        raise RuntimeError("the scaled compact-support kernel disagrees with "
                           "the CPU")
    return out


def _p17_kernel_shapes():
    """The kernels at the shapes phase 17's paths give them, each against
    its plain version and timed beside the plain version, the library
    call and the bound: the leaf Cholesky at each rank's (256, 196) leaves
    under ``mesh=`` (float64, float32), and the DIA matvec in float64 on
    bench_dia's band at r = 16 and at the width of the launches that the
    solver's prepared apply splits each rank's ``sharded_predict`` block
    into (:func:`george_tpu_torch.ops.dia.stream_width`), then that apply
    on the whole block against the plain version."""
    import torch
    from george_tpu_torch.ops import chol, dia

    out = {}
    for dtype, tol in ((torch.float64, 1e-10), (torch.float32, 1e-4)):
        A = _spd(256, 196, dtype)
        name = "leaf_256x196_%s" % str(dtype).split(".")[-1]
        err = _check_chol(chol.cholesky_cuda, "chol_kernel_launches", A, tol,
                          "parallel kernel (256, 196) %s" % name[-7:])
        t = _time_chol(chol.cholesky_cuda, A)
        t["max_abs_err"] = err
        out[name] = t
        log("parallel kernel time %s: kernel %.4f ms, plain %.4f ms, "
            "torch.linalg.cholesky %.4f ms, bound %.4f ms (%s)"
            % (name, t["ms"], t["plain_ms"], t["library_ms"], t["bound_ms"],
               t["bound_by"]))
    x, _, _, _, kernel = bench_dia_dataset(N_DIA)
    f64 = torch.float64
    offsets, vals, mask, _ = dia_table(x, kernel, (f64,))
    v = vals[f64]
    n, D = v.shape
    cols = P17_T_SPARSE // P17_RANKS
    width = dia.stream_width(n, D, cols, f64)
    diag = torch.full((n,), 0.01, device="cuda", dtype=f64)
    g = torch.Generator(device="cuda").manual_seed(2)
    A = _csr_of_band(v, offsets, mask, diag)
    for r in (16, width):
        y = torch.randn((n, r), generator=g, device="cuda", dtype=f64)
        res, err = _check_dia("bench n=%d D=%d r=%d f64 [%s]" % (
            n, D, r, dia.launch_plan(n, D, r, f64).variant), v, offsets,
            diag, y, 1e-12)
        t = {"max_abs_err": err,
             "ms": cuda_ms(lambda: dia.dia_matvec_cuda(v, offsets, diag, y)),
             "plain_ms": cuda_ms(
                 lambda: dia.dia_matvec_plain(v, offsets, diag, y)),
             "library_ms": cuda_ms(lambda: A @ y)}
        t["bound_ms"], t["bound_by"] = bound(
            v.element_size() * (n * D + n + 2 * n * r),
            2.0 * n * (D + 1) * r, f64)
        out["dia_r%d_float64" % r] = t
        log("parallel kernel time dia n=%d D=%d r=%d f64: kernel %.4f ms, "
            "plain %.4f ms, cuSPARSE CSR %.4f ms, bound %.4f ms (%s)"
            % (n, D, r, t["ms"], t["plain_ms"], t["library_ms"],
               t["bound_ms"], t["bound_by"]))
    out["dia_stream_width_float64"] = width
    # the prepared apply on one rank's whole block: launches of ``width``
    op = dia.DiaOperator(offsets, n)
    y = torch.randn((n, cols), generator=g, device="cuda", dtype=f64)
    before = dia.dia_kernel_launches
    res = op(v, diag, y)
    torch.cuda.synchronize()
    launches = dia.dia_kernel_launches - before
    ref = dia.dia_matvec_plain(v, offsets, diag, y)
    err = float((res - ref).abs().max())
    scale = float(ref.abs().max())
    del ref
    ms = cuda_ms(lambda: op(v, diag, y))
    out["dia_operator_r%d_float64" % cols] = {
        "launches": launches, "width": width, "max_abs_err": err, "ms": ms}
    log("parallel kernel dia: the prepared apply at n=%d D=%d r=%d f64 in "
        "%d launches of at most %d columns, %.4f ms, max|d| %.3e = %.3e "
        "max|out| (limit 1e-12)" % (n, D, cols, launches, width, ms, err,
                                    err / scale))
    if not (err <= 1e-12 * scale and launches == -(-cols // width)):
        raise RuntimeError("the DIA operator's split launches disagree with "
                           "the plain version")
    return out


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _p17_record():
    """Count this process's leaf-kernel and DIA-kernel launches from 0 and
    record each launch's shape; returns ``stop``, ``stop()`` giving
    ``{"leaf": n, "leaf_B": [...], "leaf_shapes": [(B, m, m, dtype), ...],
    "leaf_by_shape": {"(B, m) dtype": n, ...}, "dia": n, "dia_r": [...], "dia_shapes": [(n, D, d_min, r, dtype),
    ...], "cg": n}``, ``"cg"`` the CG step kernel's launches."""
    from george_tpu_torch.ops import cg, chol, dia

    chol.chol_kernel_launches = 0
    dia.dia_kernel_launches = 0
    cg.cg_device_steps = 0
    shapes = {"leaf": [], "dia": []}
    leaf, launch = chol.cholesky_cuda, dia._launch

    def rec_leaf(A):
        shapes["leaf"].append(tuple(A.shape) + (str(A.dtype)[6:],))
        return leaf(A)

    def rec_dia(vals, diag, y, d_min, D, *args):
        shapes["dia"].append((int(y.shape[0]), int(D), int(d_min),
                              1 if y.ndim == 1 else int(y.shape[1]),
                              str(y.dtype)[6:]))
        return launch(vals, diag, y, d_min, D, *args)

    chol.cholesky_cuda, dia._launch = rec_leaf, rec_dia

    def stop():
        chol.cholesky_cuda, dia._launch = leaf, launch
        return {"leaf": chol.chol_kernel_launches,
                "leaf_B": sorted(set(b for b, _, _, _ in shapes["leaf"])),
                "leaf_shapes": sorted(set(shapes["leaf"])),
                "leaf_by_shape": {
                    "(%d, %d) %s" % (b, m, dt): shapes["leaf"].count(
                        (b, m, m2, dt))
                    for b, m, m2, dt in sorted(set(shapes["leaf"]))},
                "dia": dia.dia_kernel_launches,
                "dia_r": sorted(set(r for _, _, _, r, _ in shapes["dia"])),
                "dia_shapes": sorted(set(shapes["dia"])),
                "cg": cg.cg_device_steps}

    return stop


def _p17_mesh_gp(mesh, dtype):
    """(b) on this rank: the smooth n = 1e5 GP with ``HODLRSolver(mesh=)``:
    compute, likelihood, exact gradient (float64), prediction at 1000
    points, with this rank's leaf launches, compute seconds, seconds per
    value + gradient and peak memory."""
    import torch
    import george_tpu_torch as gtt

    x, y, yerr, kernel = smooth_dataset(N_MAIN)
    stop = _p17_record()
    torch.cuda.reset_peak_memory_stats()
    gp = gtt.GP(kernel, solver=gtt.HODLRSolver, min_size=128, rank=12,
                mesh=mesh, device="cuda", dtype=dtype)
    sync("cuda")
    t0 = time.perf_counter()
    gp.compute(x, yerr)
    sync("cuda")
    out = {"compute_s": time.perf_counter() - t0,
           "ll": gp.log_likelihood(y), "sharded": gp.solver._shard is not None,
           "local_leaves": int(gp.solver._factors["Lleaf"].shape[0])}
    if dtype == torch.float64:
        gp.grad_log_likelihood(y)
        sync("cuda")
        t0 = time.perf_counter()
        out["grad"] = gp.grad_log_likelihood(y)
        sync("cuda")
        out["eval_s"] = time.perf_counter() - t0
        t = np.linspace(0.0, 1000.0, P17_T_MESH)
        out["mu"], out["var"] = gp.predict(y, t, return_var=True)
    out["launches"] = stop()
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out


def _p17_sym_rows():
    """(g)'s rows for ``apply_sqrt`` ``(8, n)`` and columns for
    ``apply_inverse_sym_W`` ``(n, 8)``."""
    rng = np.random.default_rng(17)
    return (rng.standard_normal((P17_SYM_ROWS, N_MAIN)),
            rng.standard_normal((N_MAIN, P17_SYM_ROWS)))


def _p17_sym_surface(gp, y):
    """What (g) holds of a ``sym=True`` GP on the smooth dataset."""
    s = gp.solver
    R, Y = _p17_sym_rows()
    out = {"ll": gp.log_likelihood(y), "logdet": s.log_determinant,
           "sqrt": s.apply_sqrt(R), "winv": s.apply_inverse_sym_W(Y)}
    np.random.seed(P17_SAMPLE_SEED)
    out["sample"] = gp.sample()
    return out


def _p17_mesh_sym(mesh):
    """(g) on this rank: ``HODLRSolver(mesh=, sym=True)`` on the smooth
    n = 1e5 dataset in float64: compute, likelihood, log-determinant,
    ``apply_sqrt`` of 8 rows, ``apply_inverse_sym_W`` of 8 columns,
    ``GP.sample`` and the exact gradient, with this rank's leaf launches
    and their shapes, seconds and peak memory."""
    import torch
    import george_tpu_torch as gtt

    x, y, yerr, kernel = smooth_dataset(N_MAIN)
    stop = _p17_record()
    torch.cuda.reset_peak_memory_stats()
    gp = gtt.GP(kernel, solver=gtt.HODLRSolver, min_size=128, rank=12,
                sym=True, mesh=mesh, device="cuda", dtype=torch.float64)
    sync("cuda")
    t0 = time.perf_counter()
    gp.compute(x, yerr)
    sync("cuda")
    out = {"compute_s": time.perf_counter() - t0,
           "sharded": gp.solver._shard is not None,
           "local_leaves": int(gp.solver._factors["Lleaf"].shape[0])}
    out.update(_p17_sym_surface(gp, y))
    gp.grad_log_likelihood(y)
    sync("cuda")
    t0 = time.perf_counter()
    out["grad"] = gp.grad_log_likelihood(y)
    sync("cuda")
    out["eval_s"] = time.perf_counter() - t0
    out["launches"] = stop()
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out


def _p17_sparse_lp_gp(mesh, dtype):
    """(h)'s GP: bench_dia's data (seed 0) at ``P17_N_LP`` through the
    iterative sparse solver (``direct=False``), rows split over ``mesh``
    (``None``: one rank), computed; with ``y``, ``yerr`` and the compute
    seconds."""
    import george_tpu_torch as gtt

    x, _, y, yerr, kernel = bench_dia_dataset(P17_N_LP)
    gp = gtt.GP(kernel, solver=gtt.SparseSolver, direct=False, mesh=mesh,
                device="cuda", dtype=dtype)
    sync("cuda")
    t0 = time.perf_counter()
    gp.compute(x, yerr)
    sync("cuda")
    return gp, x, y, yerr, time.perf_counter() - t0


def _p17_sparse_lp_eval(gp, x, y, yerr, dtype, chains):
    """Value and gradient of ``gp.log_prob_fn`` at the computed parameters
    (``ll``, ``grad``) with their seconds: one call, or with ``chains`` one
    ``vmap`` over the chains of ``P17_LP_SHIFTS``, the first of which is
    the computed parameters (``vmap_ll``, ``vmap_grad`` hold them all)."""
    import torch

    f = gp.log_prob_fn(x, y, yerr)
    theta = torch.as_tensor(gp.get_parameter_vector(), device="cuda",
                            dtype=dtype)
    sync("cuda")
    t0 = time.perf_counter()
    if chains:
        thetas = theta[None, :] + torch.as_tensor(
            P17_LP_SHIFTS, device="cuda", dtype=dtype)
        g, v = torch.func.vmap(torch.func.grad_and_value(f))(thetas)
    else:
        g, v = torch.func.grad_and_value(f)(theta)
    sync("cuda")
    out = {"seconds": time.perf_counter() - t0,
           "logdet": gp.solver.log_determinant}
    v, g = v.double().cpu().numpy(), g.double().cpu().numpy()
    if chains:
        out.update(vmap_ll=v, vmap_grad=g)
        v, g = v[0], g[0]
    out.update(ll=float(v), grad=g)
    return out


def _p17_sparse_log_prob(mesh):
    """(h) on this rank: ``SparseSolver(mesh=).loglike_fn`` through
    ``GP.log_prob_fn`` on bench_dia's data at ``P17_N_LP``, float64 (one
    call) then float32 (one ``vmap`` over 2 chains; each chain's CG and
    SLQ run one after another, so this is twice a call), with seconds,
    peak memory and launches of each."""
    import torch

    out = {}
    for dtype in (torch.float64, torch.float32):
        stop = _p17_record()
        torch.cuda.reset_peak_memory_stats()
        gp, x, y, yerr, compute_s = _p17_sparse_lp_gp(mesh, dtype)
        res = _p17_sparse_lp_eval(gp, x, y, yerr, dtype,
                                  dtype == torch.float32)
        res.update(compute_s=compute_s, sharded=gp.solver._shard is not None,
                   rows=int(gp.solver._nbr.shape[0]), launches=stop(),
                   peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        out[str(dtype).split(".")[-1]] = res
        del gp
        torch.cuda.empty_cache()
    return out


def _p17_predict_gps(which):
    """The GPs of (c), computed on the card in float64: ``(gp, y, t)``."""
    import torch
    import george_tpu_torch as gtt

    f64 = torch.float64
    if which == "hodlr":
        x, y, yerr, kernel = smooth_dataset(N_MAIN)
        gp = gtt.GP(kernel, solver=gtt.HODLRSolver, min_size=128, rank=12,
                    device="cuda", dtype=f64)
        t = np.linspace(0.0, 1000.0, P17_T_HODLR)
    elif which == "sparse":
        x, _, y, yerr, kernel = bench_dia_dataset(N_DIA)
        gp = gtt.GP(kernel, solver=gtt.SparseSolver, direct=False,
                    device="cuda", dtype=f64)
        t = np.linspace(x.min(), x.max(), P17_T_SPARSE)
    else:
        x, y, yerr = hmatrix_dataset(P17_N_HM, 3)
        gp = hmatrix_gp("cuda", f64)
        t = np.random.default_rng(5).uniform(
            0, 12.0 * np.sqrt(P17_N_HM / 2000.0), (P17_T_HM, 2))
    gp.compute(x, yerr)
    return gp, y, t


def _p17_ref_points(which):
    """The test points of (c) at which ``gp.predict`` on one rank is the
    reference: every ``P17_REF_STRIDE[which]``-th."""
    return slice(None, None, P17_REF_STRIDE[which])


def _p17_sharded_predict(mesh):
    """(c) on this rank: ``sharded_predict`` on the three solvers, with
    this rank's launches of each kernel and its column count."""
    import torch
    from george_tpu_torch import parallel

    out = {}
    for which in ("hodlr", "sparse", "hmatrix"):
        stop = _p17_record()
        gp, y, t = _p17_predict_gps(which)
        compute = stop()
        stop = _p17_record()
        sync("cuda")
        t0 = time.perf_counter()
        mu, var = parallel.sharded_predict(mesh, gp, y, t)
        sync("cuda")
        out[which] = {"mu": mu, "var": var,
                      "seconds": time.perf_counter() - t0,
                      "launches_compute": compute, "launches": stop(),
                      "columns": -(-len(t) // mesh.size())}
        del gp
        torch.cuda.empty_cache()
    return out


def _p17_samplers(mesh):
    """(d) on this rank: NUTS at bench_nuts's n = 512 configuration and
    the stretch-move ensemble, the chains split over the ranks."""
    import torch
    from george_tpu_torch import parallel

    _, log_prob, v0, p0 = nuts_model("cuda", torch.float64)
    parallel.sharded_sample_nuts(mesh, 1, log_prob, p0, num_warmup=1,
                                 num_samples=1, **P17_NUTS_KW)
    sync("cuda")
    t0 = time.perf_counter()
    samples, stats = parallel.sharded_sample_nuts(
        mesh, 0, log_prob, p0, num_warmup=NUTS_STEPS, num_samples=NUTS_STEPS,
        **P17_NUTS_KW)
    sync("cuda")
    seconds = time.perf_counter() - t0
    out = {"samples": samples.cpu().numpy(), "seconds": seconds,
           "step_size": stats["step_size"].cpu().numpy(),
           "sigma": stats["inv_mass"]["sigma"].cpu().numpy(),
           "leapfrog_evals": stats["leapfrog_evals"],
           "samples_per_sec": samples.shape[0] * samples.shape[1] / seconds}
    walkers = _p17_walkers(v0)
    batched = torch.func.vmap(log_prob)
    chain, logp, acc = parallel.sharded_run_ensemble(mesh, 3, walkers,
                                                     batched, 50)
    out["ensemble"] = (chain.cpu().numpy(), logp.cpu().numpy(),
                       acc.cpu().numpy())
    return out


def _p17_walkers(v0):
    return v0[None, :] + 1e-3 * np.random.default_rng(4).standard_normal(
        (32, len(v0)))


def _p17_rank(rank, world, port, backend, tasks, queue):
    """One rank of phase 17: join the group (``parallel.initialize``, the
    backend picked automatically unless given), run ``tasks`` on a mesh
    over it, and put ``(rank, results)`` (or the traceback) on ``queue``."""
    import datetime
    import traceback

    try:
        import torch
        import torch.distributed as dist
        from george_tpu_torch import parallel

        torch.cuda.set_device(0)
        parallel.initialize(
            init_method="tcp://127.0.0.1:%d" % port, rank=rank,
            world_size=world, backend=backend,
            timeout=datetime.timedelta(seconds=P17_RENDEZVOUS_S))
        mesh = parallel.chain_mesh()
        group = mesh.get_group()
        out = {"backend": dist.get_backend(group)}
        # a collective of each kind on the card, checked
        ones = torch.ones(4, device="cuda", dtype=torch.float64)
        from george_tpu_torch.parallel import collectives as C

        out["all_reduce_ok"] = bool(torch.all(C.all_reduce(ones, group)
                                              == world))
        out["all_gather_ok"] = bool(C.gather_rows(ones * rank, group).shape
                                    == (4 * world,))
        out["broadcast_ok"] = bool(torch.all(C.broadcast(ones * rank, group)
                                             == 0))
        for task in tasks:
            t0 = time.perf_counter()
            out[task] = globals()[task](mesh)
            out[task + "_s"] = time.perf_counter() - t0
        queue.put((rank, out))
        dist.destroy_process_group()
    except Exception:      # reported to the parent, which raises
        queue.put((rank, {"error": traceback.format_exc()}))


def _p17_spawn(world, tasks, backend=None):
    """Run ``tasks`` on ``world`` spawned ranks sharing the card; returns
    each rank's results, or raises with the failed ranks' tracebacks."""
    import queue as queue_mod

    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_p17_rank,
                         args=(r, world, port, backend, tasks, q))
             for r in range(world)]
    for p in procs:
        p.start()
    results, deadline = {}, time.perf_counter() + P17_JOIN_S
    try:
        while len(results) < world:
            left = deadline - time.perf_counter()
            if left <= 0:
                raise RuntimeError("phase 17: ranks %s did not finish in %d s"
                                   % (sorted(set(range(world)) - set(results)),
                                      P17_JOIN_S))
            try:
                rank, res = q.get(timeout=min(left, 10.0))
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if not p.is_alive() and r not in results]
                if dead:
                    time.sleep(2.0)       # a result may still be in flight
                    if q.empty():
                        raise RuntimeError("phase 17: ranks %s exited "
                                           "without a result" % dead)
                continue
            results[rank] = res
            if "error" in res:      # the others may wait on it: stop soon
                deadline = min(deadline, time.perf_counter() + 10.0)
        for p in procs:
            p.join(60)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    errors = ["rank %d:\n%s" % (r, res["error"])
              for r, res in sorted(results.items()) if "error" in res]
    if errors:
        raise RuntimeError("phase 17 failed on the ranks:\n" + "\n".join(
            errors))
    return [results[r] for r in range(world)]


def phase_parallel(device, nuts_ref=None):
    """Phase 17: (a) the kernel API; (b)-(d), (g) and (h) on 2 gloo ranks
    sharing the card, against one-rank references computed here first;
    (e) a one-rank NCCL group running (c)'s HODLR case; (f) the port's dry
    run (``entry.dryrun_multichip``) on the card. ``nuts_ref`` is phase
    11's float64 ``(samples, stats, samples_per_sec)`` at ``NUTS_STEPS``
    (8 chains in one batch), reported beside (d)'s check when given.
    (h)'s float32 run is held to the direct float64 path at ``P17_N_LP``,
    computed here first."""
    import torch
    import torch.distributed as dist
    from george_tpu_torch import parallel
    from george_tpu_torch.sampling import run_ensemble

    t_phase = time.perf_counter()
    x, _, y, yerr, kernel = bench_dia_dataset(P17_N_LP)
    sparse_ref = phase_sparse_direct((x, y, yerr, kernel))["float64"]
    out = {"kernels": _p17_kernel_shapes()}
    torch.cuda.empty_cache()
    out["a"] = phase_kernel_api(device)
    torch.cuda.empty_cache()

    # one-rank references, on this process
    t0 = time.perf_counter()
    ref = {}
    x, y, yerr, kernel = smooth_dataset(N_MAIN)
    import george_tpu_torch as gtt

    gp = gtt.GP(kernel, solver=gtt.HODLRSolver, min_size=128, rank=12,
                device=device, dtype=torch.float64)
    gp.compute(x, yerr)
    mu, var = gp.predict(y, np.linspace(0.0, 1000.0, P17_T_MESH),
                         return_var=True)
    ref["mesh"] = {"ll": gp.log_likelihood(y),
                   "grad": gp.grad_log_likelihood(y), "mu": mu, "var": var}
    del gp
    # (g)'s: the symmetric factorization on one rank; its exact gradient
    # is the fused likelihood's, through the same SMW cascade as (b)'s
    t1 = time.perf_counter()
    gp = gtt.GP(kernel, solver=gtt.HODLRSolver, min_size=128, rank=12,
                sym=True, device=device, dtype=torch.float64)
    gp.compute(x, yerr)
    ref["sym"] = _p17_sym_surface(gp, y)
    sync(device)
    ref["sym_s"] = time.perf_counter() - t1
    del gp
    # (h)'s: the iterative sparse log_prob_fn on one rank, float64
    t1 = time.perf_counter()
    gp, xs, ys, yerrs, _ = _p17_sparse_lp_gp(None, torch.float64)
    ref["sparse_lp"] = _p17_sparse_lp_eval(gp, xs, ys, yerrs, torch.float64,
                                           False)
    ref["sparse_lp_s"] = time.perf_counter() - t1
    del gp
    torch.cuda.empty_cache()
    for which in ("hodlr", "sparse", "hmatrix"):
        gp, yy, t = _p17_predict_gps(which)
        t1 = time.perf_counter()
        ref[which] = gp.predict(yy, t[_p17_ref_points(which)],
                                return_var=True)
        sync(device)
        ref[which + "_s"] = time.perf_counter() - t1
        del gp
        torch.cuda.empty_cache()
    # the unsharded NUTS run that (d) is held to: the chains evaluated 4
    # at a time, the batch of each rank (a chain rounds by its batch, and
    # the warmup's adaptation amplifies that into different draws)
    from george_tpu_torch.sampling.hmc import _sample

    _, log_prob, v0, p0 = nuts_model(device, torch.float64)
    p0_t = torch.as_tensor(p0, device=device)
    _sample(1, p0_t, log_prob, 1, 1, _chain_batch=4, **P17_NUTS_KW)
    sync(device)
    t1 = time.perf_counter()
    samples, stats = _sample(0, p0_t, log_prob, NUTS_STEPS, NUTS_STEPS,
                             _chain_batch=4, **P17_NUTS_KW)
    sync(device)
    seconds = time.perf_counter() - t1
    ref["nuts"] = (samples, stats,
                   samples.shape[0] * samples.shape[1] / seconds)
    walkers = torch.as_tensor(_p17_walkers(v0), device=device)
    ref["ensemble"] = [a.cpu().numpy() for a in run_ensemble(
        3, walkers, torch.func.vmap(log_prob), 50)]
    out["reference_s"] = time.perf_counter() - t0
    log("parallel: one-rank references %.1f s" % out["reference_s"])
    torch.cuda.empty_cache()

    # (b)-(d) on 2 ranks sharing the card
    t0 = time.perf_counter()
    ranks = _p17_spawn(P17_RANKS, ["_p17_mesh_f64", "_p17_mesh_f32",
                                   "_p17_sharded_predict", "_p17_samplers",
                                   "_p17_mesh_sym", "_p17_sparse_log_prob"])
    out["ranks_s"] = time.perf_counter() - t0
    for r, res in enumerate(ranks):
        log("parallel rank %d: backend %s; all_reduce, all_gather, broadcast "
            "of CUDA tensors %s; tasks %s" % (
                r, res["backend"],
                (res["all_reduce_ok"], res["all_gather_ok"],
                 res["broadcast_ok"]),
                {k: round(v, 1) for k, v in res.items() if k.endswith("_s")}))
        if res["backend"] != "gloo" or not (
                res["all_reduce_ok"] and res["all_gather_ok"]
                and res["broadcast_ok"]):
            raise RuntimeError("phase 17: rank %d's collectives failed" % r)
    out["b"] = _p17_check_mesh(ranks, ref["mesh"])
    out["c"] = _p17_check_predict(ranks, ref)
    out["d"] = _p17_check_samplers(ranks, ref, nuts_ref)
    out["g"] = _p17_check_sym(ranks, ref)
    out["h"] = _p17_check_sparse_lp(ranks, ref, sparse_ref)

    # (e) NCCL, one rank
    t0 = time.perf_counter()
    (nccl,) = _p17_spawn(1, ["_p17_predict_hodlr"])
    e = nccl["_p17_predict_hodlr"]
    pts = _p17_ref_points("hodlr")
    err = max(_max_rel(e["mu"][pts], ref["hodlr"][0]),
              _max_rel(e["var"][pts], ref["hodlr"][1]))
    out["e"] = {"backend": nccl["backend"], "seconds": e["seconds"],
                "rel_vs_predict": err, "launches": e["launches_compute"]}
    log("parallel (e): a one-rank %s group, CUDA collectives %s; "
        "sharded_predict of HODLR n=%d at %d points %.3f s, rel vs "
        "gp.predict %.3e (limit 1e-8); leaf launches %s"
        % (nccl["backend"], (nccl["all_reduce_ok"], nccl["all_gather_ok"],
                             nccl["broadcast_ok"]), N_MAIN, P17_T_HODLR,
           e["seconds"], err, e["launches_compute"]))
    if nccl["backend"] != "nccl" or not err <= 1e-8 or not (
            nccl["all_reduce_ok"] and nccl["all_gather_ok"]
            and nccl["broadcast_ok"]):
        raise RuntimeError("phase 17 (e): the NCCL group failed")
    out["e_s"] = time.perf_counter() - t0

    # (f) the port's multi-rank dry run on the card
    from george_tpu_torch.entry import dryrun_multichip

    t0 = time.perf_counter()
    f = dryrun_multichip(P17_RANKS, timeout=P17_JOIN_S)
    out["f"] = dict(f, seconds=time.perf_counter() - t0)
    log("parallel (f): entry.dryrun_multichip(%d) on the card, %.1f s: %d "
        "walkers, sharded ensemble sweep vs unsharded %.3e (limit 1e-8), "
        "row-sharded HODLR ll %.6f (sharded %s)"
        % (P17_RANKS, out["f"]["seconds"], f["nwalkers"],
           f["ensemble_vs_unsharded"], f["hodlr_ll"], f["hodlr_sharded"]))
    if not (f["hodlr_sharded"] and np.isfinite(f["hodlr_ll"])
            and f["ensemble_vs_unsharded"] <= 1e-8):
        raise RuntimeError("phase 17 (f): the dry run on the card failed")
    out["seconds"] = time.perf_counter() - t_phase
    log("parallel: phase 17 %.1f s" % out["seconds"])
    return out


def _p17_mesh_f64(mesh):
    import torch

    return _p17_mesh_gp(mesh, torch.float64)


def _p17_mesh_f32(mesh):
    import torch

    return _p17_mesh_gp(mesh, torch.float32)


def _p17_predict_hodlr(mesh):
    from george_tpu_torch import parallel

    stop = _p17_record()
    gp, y, t = _p17_predict_gps("hodlr")
    compute = stop()
    sync("cuda")
    t0 = time.perf_counter()
    mu, var = parallel.sharded_predict(mesh, gp, y, t)
    sync("cuda")
    return {"mu": mu, "var": var, "seconds": time.perf_counter() - t0,
            "launches_compute": compute}


def _p17_check_mesh(ranks, ref):
    """(b): each rank's sharded GP against the anchor and the one-rank
    run (the JAX test's ``np.allclose`` bounds)."""
    out = {}
    for r, res in enumerate(ranks):
        m64, m32 = res["_p17_mesh_f64"], res["_p17_mesh_f32"]
        rel64 = check_anchor("parallel (b) rank %d f64 mesh" % r, m64["ll"],
                             ANCHOR_F64, N_MAIN)
        rel32 = check_anchor("parallel (b) rank %d f32 mesh" % r, m32["ll"],
                             ANCHOR_F32, N_MAIN)
        grad_ok = bool(np.allclose(m64["grad"], ref["grad"], atol=1e-6))
        mu_ok = bool(np.allclose(m64["mu"], ref["mu"], atol=1e-8))
        var_ok = bool(np.allclose(m64["var"], ref["var"], atol=1e-8))
        dg = float(np.max(np.abs(m64["grad"] - ref["grad"])))
        dm = float(np.max(np.abs(m64["mu"] - ref["mu"])))
        dv = float(np.max(np.abs(m64["var"] - ref["var"])))
        row = {"ll_rel_anchor_f64": rel64, "ll_rel_anchor_f32": rel32,
               "grad_max_abs_vs_1rank": dg, "mu_max_abs_vs_1rank": dm,
               "var_max_abs_vs_1rank": dv}
        for tag, m in (("f64", m64), ("f32", m32)):
            row[tag] = {k: m[k] for k in ("compute_s", "launches", "peak_gb",
                                          "local_leaves", "sharded")}
        row["f64"]["eval_s"] = m64["eval_s"]
        out[r] = row
        log("parallel (b) rank %d: sharded %s, %d local leaves; f64 compute "
            "%.3f s, value + gradient %.3f s, peak %.2f GB, leaf launches "
            "%s; f32 compute %.3f s, peak %.2f GB, leaf launches %s; vs one "
            "rank: gradient %.3e, mean %.3e, variance %.3e (np.allclose "
            "atol 1e-6, 1e-8, 1e-8: %s)"
            % (r, m64["sharded"], m64["local_leaves"], m64["compute_s"],
               m64["eval_s"], m64["peak_gb"], m64["launches"],
               m32["compute_s"], m32["peak_gb"], m32["launches"], dg, dm, dv,
               (grad_ok, mu_ok, var_ok)))
        if not (grad_ok and mu_ok and var_ok and m64["sharded"]
                and m64["local_leaves"] == 256
                and m64["launches"]["leaf"] > 0
                and m64["launches"]["leaf_B"] == [256]
                and m32["launches"]["leaf"] > 0):
            raise RuntimeError("parallel (b): rank %d disagrees or did not "
                               "launch the leaf kernel on its leaves" % r)
    return out


def _p17_check_predict(ranks, ref):
    """(c): ``sharded_predict`` on each solver against ``gp.predict`` on
    one rank (1e-8 of the largest value), with each rank's launches."""
    out = {}
    for which in ("hodlr", "sparse", "hmatrix"):
        mu_ref, var_ref = ref[which]
        row = {"predict_1rank_s": ref[which + "_s"]}
        for r, res in enumerate(ranks):
            c = res["_p17_sharded_predict"][which]
            pts = _p17_ref_points(which)
            err = max(_max_rel(c["mu"][pts], mu_ref),
                      _max_rel(c["var"][pts], var_ref))
            row[r] = {"rel": err, "seconds": c["seconds"],
                      "columns": c["columns"], "launches": c["launches"],
                      "launches_compute": c["launches_compute"]}
            log("parallel (c) %s rank %d: sharded_predict of %d columns "
                "%.3f s (gp.predict on one rank at %d points: %.3f s), rel "
                "vs gp.predict %.3e (limit 1e-8); launches in compute %s, "
                "in predict %s"
                % (which, r, c["columns"], c["seconds"], len(mu_ref),
                   ref[which + "_s"], err, c["launches_compute"],
                   c["launches"]))
            if not err <= 1e-8:
                raise RuntimeError("parallel (c) %s: rank %d disagrees"
                                   % (which, r))
            if which == "sparse" and c["launches"]["dia"] == 0:
                raise RuntimeError("parallel (c): sharded sparse prediction "
                                   "never launched the DIA kernel")
            if which == "hodlr" and c["launches_compute"]["leaf"] == 0:
                raise RuntimeError("parallel (c): the HODLR compute never "
                                   "launched the leaf kernel")
        out[which] = row
    return out


def _p17_check_samplers(ranks, ref, nuts_ref):
    """(d): sharded NUTS against the unsharded run of 4-chain batches with
    the same seed (the JAX test's bounds), beside phase 11's run of one
    8-chain batch (not held: it rounds differently); the ensemble against
    unsharded."""
    def host(samples, stats):
        return (samples.double().cpu().numpy(),
                stats["step_size"].double().cpu().numpy(),
                stats["inv_mass"]["sigma"].double().cpu().numpy())

    s_ref, eps_ref, sig_ref = host(*ref["nuts"][:2])
    out = {"samples_per_sec_1rank_batch4": ref["nuts"][2],
           "samples_per_sec_1rank": None if nuts_ref is None
           else nuts_ref[2]}
    for r, res in enumerate(ranks):
        d = res["_p17_samplers"]
        ds = float(np.max(np.abs(d["samples"] - s_ref)))
        de = float(np.max(np.abs(d["step_size"] - eps_ref) / eps_ref))
        dm = float(np.max(np.abs(d["sigma"] - sig_ref)))
        ens = [float(np.max(np.abs(a - b)))
               for a, b in zip(d["ensemble"], ref["ensemble"])]
        d8 = None
        if nuts_ref is not None:
            s8 = host(*nuts_ref[:2])[0]
            d8 = float(np.max(np.abs(d["samples"] - s8)))
        out[r] = {"samples_max_abs": ds, "step_size_max_rel": de,
                  "inv_mass_max_abs": dm, "ensemble_max_abs": ens,
                  "samples_max_abs_vs_one_batch_of_8": d8,
                  "samples_per_sec_2ranks": d["samples_per_sec"],
                  "seconds": d["seconds"],
                  "leapfrog_evals": d["leapfrog_evals"]}
        log("parallel (d) rank %d: NUTS n=512 f64 on 2 ranks (4 chains "
            "each) %.3f samples/s in %.3f s (one rank: %.3f samples/s in "
            "batches of 4, %s in one batch of 8); vs the unsharded run in "
            "batches of 4: draws %.3e (limit 1e-6), step size rel %.3e "
            "(1e-9), inverse mass %.3e (1e-12); vs phase 11's one batch of "
            "8 (not held): draws %s; ensemble (32 walkers, 50 steps) "
            "chain, logp, accept %s (limit 1e-12)"
            % (r, d["samples_per_sec"], d["seconds"], ref["nuts"][2],
               "n/a" if nuts_ref is None else "%.3f" % nuts_ref[2], ds, de,
               dm, "n/a" if d8 is None else "%.3e" % d8,
               ["%.3e" % v for v in ens]))
        if not (ds <= 1e-6 and de <= 1e-9 and dm <= 1e-12
                and max(ens) <= 1e-12):
            raise RuntimeError("parallel (d): rank %d's samplers disagree "
                               "with the unsharded runs" % r)
    return out


def _p17_check_sym(ranks, ref):
    """(g): each rank's ``HODLRSolver(mesh=, sym=True)`` against the
    anchor and the one-rank ``sym=True`` run: log-determinant 1e-10
    relative; ``apply_sqrt`` rows, ``W^{-1}`` columns and the ``GP.sample``
    draw 1e-5 of the largest entry, the ``rtol`` of (b)'s ``np.allclose``
    bounds: the row split reorders the ridge-regime skeleton solves
    (cond(G) ~ 5e14, ROADMAP Queue 3 item 3), which moves (b)'s gradient
    by 3e-4 and its predicted mean by 5e-7, and these products by 1e-7 to
    3e-7 (NVIDIA H100 80GB HBM3, 700 W), while the log-determinant stays
    within 1e-12; the exact gradient at (b)'s ``np.allclose`` bound; this
    rank's leaf launches all of B = 256."""
    one = ref["sym"]
    out = {"reference_s": ref["sym_s"]}
    for r, res in enumerate(ranks):
        g = res["_p17_mesh_sym"]
        row = {"ll_rel_anchor": check_anchor(
            "parallel (g) rank %d f64 sym mesh" % r, g["ll"], ANCHOR_F64,
            N_MAIN),
            "logdet_rel": abs(g["logdet"] - one["logdet"]) / abs(
                one["logdet"])}
        for key in ("sqrt", "winv", "sample"):
            row[key + "_rel"] = _max_rel(g[key], one[key])
        row["grad_max_abs_vs_1rank"] = float(np.max(np.abs(
            g["grad"] - ref["mesh"]["grad"])))
        grad_ok = bool(np.allclose(g["grad"], ref["mesh"]["grad"],
                                   atol=1e-6))
        for key in ("compute_s", "eval_s", "peak_gb", "launches",
                    "local_leaves", "sharded"):
            row[key] = g[key]
        out[r] = row
        log("parallel (g) rank %d: sym=True sharded %s, %d local leaves; "
            "compute %.3f s, value + gradient %.3f s, peak %.2f GB, leaf "
            "launches %d of shapes %s; vs one rank: logdet %.3e (limit "
            "1e-10), apply_sqrt %.3e, W^{-1} %.3e, GP.sample %.3e (limit "
            "1e-5 each), gradient %.3e (np.allclose atol 1e-6: %s)"
            % (r, g["sharded"], g["local_leaves"], g["compute_s"],
               g["eval_s"], g["peak_gb"], g["launches"]["leaf"],
               g["launches"]["leaf_shapes"], row["logdet_rel"],
               row["sqrt_rel"], row["winv_rel"], row["sample_rel"],
               row["grad_max_abs_vs_1rank"], grad_ok))
        if not (grad_ok and g["sharded"] and g["local_leaves"] == 256
                and row["logdet_rel"] <= 1e-10
                and max(row["sqrt_rel"], row["winv_rel"],
                        row["sample_rel"]) <= 1e-5
                and g["launches"]["leaf"] > 0
                and g["launches"]["leaf_B"] == [256]):
            raise RuntimeError("parallel (g): rank %d's symmetric "
                               "factorization disagrees or did not launch "
                               "the leaf kernel on its leaves" % r)
    return out


def _p17_check_sparse_lp(ranks, ref, sparse_ref):
    """(h): each rank's ``SparseSolver(mesh=)`` ``log_prob_fn`` at
    ``P17_N_LP``: float64 value and gradient against the one-rank
    iterative run (same probes, 1e-8 relative); float32 against the
    direct float64 path at that n at phase 9's estimator bounds
    (quadratic term 1e-3, log-determinant 3%, gradient 0.15 each) through
    the first chain of its ``vmap`` over 2 chains, and every chain
    finite. (The ``vmap`` against unbatched calls
    is held on the CPU, ``tests/test_torch_parallel.py``.)"""
    one = ref["sparse_lp"]
    n = P17_N_LP
    out = {"reference_s": ref["sparse_lp_s"],
           "reference_value_grad_s": one["seconds"]}
    for r, res in enumerate(ranks):
        h64, h32 = (res["_p17_sparse_log_prob"][k]
                    for k in ("float64", "float32"))
        row = {"ll_rel_f64": abs(h64["ll"] - one["ll"]) / abs(one["ll"]),
               "grad_rel_f64": float(np.max(rel(h64["grad"], one["grad"])))}
        quad = -2.0 * h32["ll"] - h32["logdet"] - n * np.log(2.0 * np.pi)
        row["quad_rel_f32"] = float(rel(quad, sparse_ref["quad"]))
        row["logdet_rel_f32"] = float(rel(h32["logdet"],
                                          sparse_ref["logdet"]))
        row["grad_rel_f32"] = rel(h32["grad"], sparse_ref["grad"]).tolist()
        for tag, h in (("f64", h64), ("f32", h32)):
            row[tag] = {k: h[k] for k in ("compute_s", "seconds", "peak_gb",
                                          "launches", "rows", "sharded")}
        row["f32"]["vmap_ll"] = h32["vmap_ll"].tolist()
        out[r] = row
        log("parallel (h) rank %d: SparseSolver(mesh=) log_prob_fn on %d "
            "of n=%d rows; f64 compute %.3f s, value + gradient %.3f s "
            "(one rank %.3f s), peak %.2f GB, ll %.10f vs one rank %.3e "
            "(limit 1e-8), gradient %.3e (limit 1e-8); f32 compute %.3f s, "
            "vmap of value + gradient over 2 chains %.3f s (ll %s), peak "
            "%.2f GB; chain 0 vs direct f64: quad %.3e (limit 1e-3), logdet "
            "%.3e (limit 3e-2), gradient %s (limit 0.15 each); launches "
            "f64 %s, f32 %s"
            % (r, h64["rows"], n, h64["compute_s"], h64["seconds"],
               one["seconds"], h64["peak_gb"], h64["ll"], row["ll_rel_f64"],
               row["grad_rel_f64"], h32["compute_s"], h32["seconds"],
               np.array2string(h32["vmap_ll"], precision=4),
               h32["peak_gb"], row["quad_rel_f32"], row["logdet_rel_f32"],
               np.array2string(np.asarray(row["grad_rel_f32"]),
                               precision=4), h64["launches"],
               h32["launches"]))
        if not (h64["sharded"] and h32["sharded"]
                and row["ll_rel_f64"] <= 1e-8 and row["grad_rel_f64"] <= 1e-8
                and row["quad_rel_f32"] <= 1e-3
                and row["logdet_rel_f32"] <= 0.03
                and max(row["grad_rel_f32"]) <= 0.15
                and np.all(np.isfinite(h32["vmap_ll"]))
                and np.all(np.isfinite(h32["vmap_grad"]))):
            raise RuntimeError("parallel (h): rank %d's sparse log_prob_fn "
                               "disagrees" % r)
    return out


# ---------------------------------------------------------------------------
# phase 18: the examples' twins on the card
# ---------------------------------------------------------------------------

# (twin, its main's arguments) in the order phase 18 runs them: every twin
# at its default size (the examples' full width), scaling also at 10,000
# (HODLR rank 48 and the exact banded path; the dense cross-check is the
# example's own, below 4000 points), hyper at its --smoke iteration counts
# on the full data (its default counts run minutes on the host-bound NUTS
# loop); multioutput's at_scale at its default n = 10,000
P18_RUNS = (("first", {}), ("scaling", {"n": 2000}),
            ("scaling", {"n": 10_000}), ("multioutput", {}), ("model", {}),
            ("mixture", {}), ("bayesopt", {}), ("hyper", {"smoke": True}),
            ("spatial", {}))


def _time_dia_shape(n, D, d_min, r, dt):
    """The DIA kernel at a shape a twin launched it at, on a random band
    of the same offsets: against the plain version (1e-12 of the largest
    entry in float64, 1e-5 in float32) and timed beside it, the cuSPARSE
    CSR product and the bound."""
    import torch
    from george_tpu_torch.ops import dia

    dtype = getattr(torch, dt)
    offsets = np.arange(d_min, d_min + D)
    vals, diag, y = _random_band(n, offsets, r, dtype, seed=18)
    label = "examples (18) n=%d D=%d r=%d %s" % (n, D, r, dt)
    _, err = _check_dia(label, vals, offsets, diag, y,
                        1e-12 if dt == "float64" else 1e-5)
    cols = (torch.arange(n, device="cuda")[:, None]
            + torch.as_tensor(offsets, device="cuda")[None, :])
    A = _csr_of_band(vals, offsets, (cols >= 0) & (cols < n), diag)
    t = {"max_abs_err": err,
         "ms": cuda_ms(lambda: dia.dia_matvec_cuda(vals, offsets, diag, y)),
         "plain_ms": cuda_ms(
             lambda: dia.dia_matvec_plain(vals, offsets, diag, y)),
         "library_ms": cuda_ms(lambda: A @ y)}
    t["bound_ms"], t["bound_by"] = bound(
        vals.element_size() * (n * D + n + 2 * n * r),
        2.0 * n * (D + 1) * r, dtype)
    log("%s: kernel %.4f ms, plain %.4f ms, cuSPARSE CSR %.4f ms, bound "
        "%.4f ms (%s)" % (label, t["ms"], t["plain_ms"], t["library_ms"],
                          t["bound_ms"], t["bound_by"]))
    return t


def phase_examples(device):
    """Phase 18: each twin of ``george_tpu_torch.examples`` in-process
    through its ``main`` on the card in float64, the kernels' launch
    counts set to 0 right before it and read right after; the example's
    own asserts are the gate. Each leaf-kernel and DIA-kernel shape a
    twin launched is then held to the plain version and timed beside it,
    the library call and the bound (outside the twin's count)."""
    import importlib

    import torch
    from george_tpu_torch.ops import chol

    out, checked, checked_dia = {}, {}, {}
    for name, kw in P18_RUNS:
        mod = importlib.import_module("george_tpu_torch.examples." + name)
        label = name + "".join("_%s%s" % (k, v) for k, v in kw.items())
        stop = _p17_record()
        sync(device)
        t0 = time.perf_counter()
        result = mod.main(device=device, dtype=torch.float64, **kw)
        sync(device)
        secs = time.perf_counter() - t0
        launches = stop()
        out[label] = {"seconds": secs, "launches": launches}
        if name == "spatial":
            out[label]["weak_leaves"] = result["weak_leaves"]
        log("examples (18) %s: %.3f s; leaf kernel launches %d (shapes %s), "
            "DIA kernel launches %d (r %s), CG step kernel launches %d"
            % (label, secs, launches["leaf"], launches["leaf_shapes"],
               launches["dia"], launches["dia_r"], launches["cg"]))
        for B, m, _, dt in launches["leaf_shapes"]:
            if (B, m, dt) in checked:
                continue
            A = _spd(B, m, getattr(torch, dt))
            label = "examples (18) leaf kernel (%d, %d) %s" % (B, m, dt)
            err = _check_chol(chol.cholesky_cuda, "chol_kernel_launches", A,
                              1e-10 if dt == "float64" else 1e-4, label)
            t = checked[(B, m, dt)] = dict(_time_chol(chol.cholesky_cuda,
                                                      A), max_abs_err=err)
            log("%s: kernel %.4f ms, plain %.4f ms, torch.linalg.cholesky "
                "%.4f ms, bound %.4f ms (%s)" % (label, t["ms"],
                                                t["plain_ms"],
                                                t["library_ms"],
                                                t["bound_ms"], t["bound_by"]))
        for shape in launches["dia_shapes"]:
            if shape not in checked_dia:
                checked_dia[shape] = _time_dia_shape(*shape)
        torch.cuda.empty_cache()
    hier = [k for k in out if k.split("_")[0] in ("scaling", "multioutput",
                                                  "spatial")]
    if any(out[k]["launches"]["leaf"] == 0 for k in hier):
        raise RuntimeError("examples (18): a hierarchical twin never "
                           "launched the leaf kernel")
    out["leaf_shapes_checked"] = [
        dict(t, B=B, m=m, dtype=dt) for (B, m, dt), t in sorted(
            checked.items())]
    out["dia_shapes_checked"] = [
        dict(t, n=n, D=D, r=r, dtype=dt)
        for (n, D, _, r, dt), t in sorted(checked_dia.items())]
    out["seconds"] = sum(v["seconds"] for v in out.values()
                         if isinstance(v, dict))
    log("examples (18): %d runs, %.1f s" % (len(P18_RUNS), out["seconds"]))
    return out


# ---------------------------------------------------------------------------
# the unsharded paths' times, for two trees of the port in one call
# ---------------------------------------------------------------------------

def _best_of(fn, runs=3):
    """Seconds of ``fn()`` between synchronizations: ``(best, all)``."""
    ts = []
    for _ in range(runs):
        sync("cuda")
        t0 = time.perf_counter()
        fn()
        sync("cuda")
        ts.append(time.perf_counter() - t0)
    return min(ts), ts


def unsharded_times():
    """This process's port on its unsharded HODLR, sparse and NUTS paths:
    the f32 Hutchinson likelihood + gradient at the smooth n = 1e5
    (``phase_slice_f32``'s protocol), the f64 likelihood and exact
    gradient there, the sparse iterative f32 compute, likelihood and
    gradient on bench_dia's data (best of 3 each), and NUTS at bench_nuts's
    n = 512 configuration in float64 for ``NUTS_STEPS`` + ``NUTS_STEPS``."""
    import torch
    import george_tpu_torch as gtt
    from george_tpu_torch.sampling import sample_nuts

    out = {}
    f32, evaluate, thetas, args = phase_slice_f32("cuda", N_MAIN)
    out["hodlr_f32_hutchinson_ms_per_eval"] = f32["ms_per_eval"]
    out["hodlr_f32_hutchinson_ms_per_eval_all"] = f32["ms_per_eval_all"]
    del evaluate, thetas, args
    x, y, yerr, kernel = smooth_dataset(N_MAIN)
    gp = gtt.GP(kernel, solver=gtt.HODLRSolver, min_size=128, rank=12,
                device="cuda", dtype=torch.float64)
    gp.compute(x, yerr)
    out["hodlr_f64_log_likelihood_s"], _ = _best_of(
        lambda: gp.log_likelihood(y))
    out["hodlr_f64_grad_s"], out["hodlr_f64_grad_s_all"] = _best_of(
        lambda: gp.grad_log_likelihood(y))
    del gp
    torch.cuda.empty_cache()
    x, _, y, yerr, kernel = bench_dia_dataset(N_DIA)
    gp = gtt.GP(kernel, solver=gtt.SparseSolver, direct=False, device="cuda",
                dtype=torch.float32)
    gp.compute(x, yerr)
    for name, fn in (("compute", lambda: gp.compute(x, yerr)),
                     ("log_likelihood", lambda: gp.log_likelihood(y)),
                     ("grad", lambda: gp.grad_log_likelihood(y))):
        best, all_ = _best_of(fn)
        out["sparse_f32_%s_s" % name] = best
        out["sparse_f32_%s_s_all" % name] = all_
    del gp
    torch.cuda.empty_cache()
    _, log_prob, _, p0 = nuts_model("cuda", torch.float64)
    kw = dict(P17_NUTS_KW)
    sample_nuts(1, log_prob, p0, num_warmup=1, num_samples=1, **kw)
    sync("cuda")
    t0 = time.perf_counter()
    samples, stats = sample_nuts(0, log_prob, p0, num_warmup=NUTS_STEPS,
                                 num_samples=NUTS_STEPS, **kw)
    sync("cuda")
    seconds = time.perf_counter() - t0
    out["nuts_f64_samples_per_sec"] = (samples.shape[0] * samples.shape[1]
                                       / seconds)
    out["nuts_f64_leapfrog_evals"] = stats["leapfrog_evals"]
    return out


def unsharded_times_ab(roots):
    """``--unsharded-times ROOT ...``: :func:`unsharded_times` once per
    ``ROOT`` (a checkout of the port; give two in turns, as ``A B B A``,
    to compare them on one card), each in a process of its own that
    imports ``george_tpu_torch`` from that checkout and builds its kernels
    there. Prints each run's JSON and, last, all of them."""
    smi = phase_device()
    runs = []
    for root in roots:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--unsharded-child",
             os.path.abspath(root)], capture_output=True, text=True,
            timeout=900)
        sys.stdout.write(proc.stdout[-4000:])
        if proc.returncode != 0:
            sys.stderr.write(proc.stderr[-8000:])
            raise SystemExit("chip_smoke: the unsharded times of %s failed"
                             % root)
        row = json.loads(proc.stdout.strip().splitlines()[-1])
        runs.append(dict(row, root=root))
        log("unsharded times, %s: %s" % (root, json.dumps(row)))
    log(smi)
    print(json.dumps({"unsharded_times": runs, "device": smi}), flush=True)


def _unsharded_child(root):
    """One run of :func:`unsharded_times_ab`, on the port under ``root``."""
    sys.path.insert(0, root)
    import george_tpu_torch
    from george_tpu_torch.ops import _build

    pkg = os.path.dirname(os.path.abspath(george_tpu_torch.__file__))
    if os.path.dirname(pkg) != root:
        raise SystemExit("chip_smoke: george_tpu_torch came from %s, not %s"
                         % (pkg, root))
    _build.build()
    _build.load()
    print(json.dumps(unsharded_times()), flush=True)


def unchunked_peak():
    """``--unchunked-peak``: the peak device memory of one Hutchinson
    evaluation in phase 19 (a)'s configuration (smooth n = 1e6, 8 probes,
    one refinement step), float32 and float64, with the chunk budget of
    the leaf and skeleton assemblies (``hodlr._CHUNK_BYTES``) at its
    default and lifted; an evaluation that does not fit prints the
    allocator's message instead of its peak."""
    import torch
    import george_tpu_torch as gtt
    from george_tpu_torch.solvers import hodlr as H

    smi = phase_device()
    phase_build()
    x, y, yerr, kernel = smooth_dataset(N_1E6)
    default, out = H._CHUNK_BYTES, {}
    for dtype in (torch.float32, torch.float64):
        gp = gtt.GP(kernel, solver=gtt.HODLRSolver, device="cuda",
                    dtype=dtype, **BENCH_1E6)
        gp.compute(x, yerr)
        args = _hutchinson_args(gp, y)
        del gp
        for name, budget in (("chunked", default), ("unchunked", 1 << 62)):
            H._CHUNK_BYTES = budget
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            gen = torch.Generator(device="cuda").manual_seed(0)
            try:
                H.hodlr_loglike_and_grad_hutchinson(
                    *args, generator=gen, num_probes=8, n_real=N_1E6,
                    refine_steps=1)
                sync("cuda")
                res = {"peak_gb": torch.cuda.max_memory_allocated() / 1e9}
            except torch.cuda.OutOfMemoryError as e:
                res = {"out_of_memory_after_peak_gb":
                       torch.cuda.max_memory_allocated() / 1e9,
                       "message": str(e).splitlines()[0]}
            finally:
                H._CHUNK_BYTES = default
            out["%s_%s" % (str(dtype).split(".")[-1], name)] = res
            log("unchunked peak, %s %s: %s" % (dtype, name, json.dumps(res)))
        del args
    log(smi)
    print(json.dumps({"unchunked_peak": out, "device": smi}), flush=True)


def cascade_dtype():
    """``--cascade-dtype``: phase 19 (a)'s float32 GP at n = 1e6 with the
    HODLR cascade's dtype (``hodlr._CASCADE``: the SMW levels, their
    solves, the skeleton ridge systems) at float32, as the JAX package runs
    it, and at float64, as the port does: the distance of the likelihood
    and of the Hutchinson likelihood from bench.py's anchor, and the
    self-check residual."""
    import warnings

    import torch
    import george_tpu_torch as gtt
    from george_tpu_torch.solvers import hodlr as H

    smi = phase_device()
    phase_build()
    x, y, yerr, kernel = smooth_dataset(N_1E6)
    default, out = H._CASCADE, {}
    for dtype in (torch.float32, torch.float64):
        H._CASCADE = dtype
        gtt.HODLRSolver._checked_configs.clear()
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                gp = gtt.GP(kernel, solver=gtt.HODLRSolver, device="cuda",
                            dtype=torch.float32, **BENCH_1E6)
                gp.compute(x, yerr)
                ll = gp.log_likelihood(y)
            gen = torch.Generator(device="cuda").manual_seed(0)
            ll_h, _ = H.hodlr_loglike_and_grad_hutchinson(
                *_hutchinson_args(gp, y), generator=gen, num_probes=8,
                n_real=N_1E6, refine_steps=1)
            res = {"ll": ll, "ll_rel": float(rel(ll, ANCHOR_1E6)),
                   "hutchinson_ll_rel": float(rel(float(ll_h), ANCHOR_1E6)),
                   "factor_residual": gp.solver.factor_residual}
        finally:
            H._CASCADE = default
        out[str(dtype).split(".")[-1]] = res
        log("cascade dtype %s (working dtype float32): %s"
            % (dtype, json.dumps(res)))
        del gp
        torch.cuda.empty_cache()
    log(smi)
    print(json.dumps({"cascade_dtype": out, "device": smi}), flush=True)


def main():
    t_start = time.perf_counter()
    smi = phase_device()
    import torch
    from george_tpu_torch.ops import cg, chol, dia

    device = "cuda"
    build_s = phase_build()
    kern = phase_kernel()
    x, y_mv, y, yerr, kernel = bench_dia_dataset(N_DIA)
    kdia = phase_kernel_dia(x, y_mv, kernel)
    kcg = phase_kernel_cg((x, y_mv, y, yerr, kernel))
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
    launches_f64 = chol.chol_kernel_launches
    log("slice f64: leaf Cholesky kernel launches %d" % launches_f64)
    if launches_f64 == 0:
        raise RuntimeError("the f64 path never launched the leaf kernel")
    del evaluate, thetas, args
    torch.cuda.empty_cache()

    # the leaf kernel under the samplers' batched evaluator
    chol.chol_kernel_launches = 0
    chains = phase_hodlr_chains(device, N_MAIN)
    launches_chains = chol.chol_kernel_launches
    log("hodlr chains: leaf Cholesky kernel launches %d" % launches_chains)
    if launches_chains == 0:
        raise RuntimeError("the chain-batched path never launched the leaf "
                           "kernel")
    torch.cuda.empty_cache()

    # phase 19: bench.py's other configurations; each part counts its own
    # leaf launches from 0
    log("bench configs (19): starting %.1f s into the run"
        % (time.perf_counter() - t_start))
    bench = phase_bench_configs(device, smi)
    bench_launches = {
        "%s_%s" % (cfg, dt): bench[cfg][dt]["launches"]
        for cfg in ("smooth_1e6", "qp_1e5") for dt in ("f32", "f64")}
    bench_launches["baseline_row3"] = bench["baseline_row3"]["launches"]
    torch.cuda.empty_cache()

    # phase 20: the CUDA graph of loglike_fn against the eager sweeps
    graph = phase_hodlr_graph(device, smi)

    # the symmetric factorization and GP.sample, float64 then float32
    chol.chol_kernel_launches = 0
    sym = {str(dt).split(".")[-1]: phase_sym(device, N_MAIN, dt, f64["grad"])
           for dt in (torch.float64, torch.float32)}
    launches_sym = chol.chol_kernel_launches
    log("sym: leaf Cholesky kernel launches %d (%.1f s into the run)"
        % (launches_sym, time.perf_counter() - t_start))
    if launches_sym == 0:
        raise RuntimeError("the sym path never launched the leaf kernel")
    torch.cuda.empty_cache()

    chol.chol_kernel_launches = 0
    selfcheck = phase_selfcheck_knn(device, 20_000, N_MAIN)
    launches_selfcheck = chol.chol_kernel_launches
    log("self-check, debug and knn: leaf Cholesky kernel launches %d"
        % launches_selfcheck)
    if launches_selfcheck == 0:
        raise RuntimeError("the self-check and knn paths never launched the "
                           "leaf kernel")
    torch.cuda.empty_cache()

    chol.chol_kernel_launches = 0
    lcm = phase_lcm(device, N_MAIN)
    launches_lcm = chol.chol_kernel_launches
    log("lcm: leaf Cholesky kernel launches %d (%.1f s into the run)"
        % (launches_lcm, time.perf_counter() - t_start))
    if launches_lcm == 0:
        raise RuntimeError("the LCM path never launched the leaf kernel")
    torch.cuda.empty_cache()

    # the strong-admissibility H-matrix solver; the leaf kernel runs in its
    # float64 1-D whitener and in the weak solver it is compared with
    chol.chol_kernel_launches = 0
    hm = phase_hmatrix(device, smi)
    launches_hm = hm["launches"]
    log("hmatrix: leaf Cholesky kernel launches %d in the H-matrix solver's "
        "whitener, %d in the weak comparison (%.1f s into the run)"
        % (launches_hm["hmatrix_solver"], launches_hm["weak_comparison"],
           time.perf_counter() - t_start))
    if launches_hm["hmatrix_solver"] == 0:
        raise RuntimeError("the H-matrix solver never launched the leaf "
                           "kernel")
    if launches_hm["weak_comparison"] == 0:
        raise RuntimeError("the weak comparison never launched the leaf "
                           "kernel")
    torch.cuda.empty_cache()

    data = (x, y, yerr, kernel)
    dia.dia_kernel_launches = 0
    cg.cg_device_steps = 0
    direct = phase_sparse_direct(data)
    log("sparse direct: DIA kernel launches %d (the (K + D) alpha of the "
        "exact gradients), CG step kernel launches %d (no CG on this path)"
        % (dia.dia_kernel_launches, cg.cg_device_steps))
    if cg.cg_device_steps != 0:
        raise RuntimeError("the sparse direct path launched the CG step")

    dia.dia_kernel_launches = 0
    cg.cg_device_steps = 0
    it, gp_it, y_it = phase_sparse_iterative(data, direct["float64"])
    dia_launches = dia.dia_kernel_launches
    cg_launches = cg.cg_device_steps
    log("sparse iterative f32: DIA kernel launches %d, CG step kernel "
        "launches %d" % (dia_launches, cg_launches))
    if dia_launches == 0:
        raise RuntimeError("the sparse iterative path never launched the DIA "
                           "kernel")
    if cg_launches == 0:
        raise RuntimeError("the sparse iterative path never launched the CG "
                           "step kernel")
    it["profile"] = profile_calls(
        [lambda: gp_it.grad_log_likelihood(y_it)], it["grad_s"] * 1e3,
        "sparse iterative f32 grad_log_likelihood")
    del gp_it
    torch.cuda.empty_cache()

    # the DIA kernel under log_prob_fn's CG and SLQ adjoints
    dia.dia_kernel_launches = 0
    cg.cg_device_steps = 0
    sparse_lp = phase_sparse_log_prob(data, direct["float64"])
    launches_lp = dia.dia_kernel_launches
    cg_launches_lp = cg.cg_device_steps
    log("sparse log_prob: DIA kernel launches %d, CG step kernel launches "
        "%d (value + gradient + minimize)" % (launches_lp, cg_launches_lp))
    if launches_lp == 0:
        raise RuntimeError("log_prob_fn's sparse path never launched the DIA "
                           "kernel")
    if cg_launches_lp == 0:
        raise RuntimeError("log_prob_fn's sparse path never launched the CG "
                           "step kernel")
    torch.cuda.empty_cache()
    cg.cg_device_steps = 0
    ell = phase_ell_2d()
    cg_launches_ell = cg.cg_device_steps
    log("sparse 2-D ELL: CG step kernel launches %d" % cg_launches_ell)
    if cg_launches_ell == 0:
        raise RuntimeError("the ELL path never launched the CG step kernel")

    # the inference layer on the dense path (no hand-written kernel on it)
    log("nuts: starting %.1f s into the run" % (time.perf_counter() - t_start))
    nuts, ckpt = {}, {}
    for dt in (torch.float64, torch.float32):
        name = str(dt).split(".")[-1]
        nuts[name], (samples, stats) = phase_nuts_512(dt)
        ckpt[name] = phase_checkpoint(samples, stats, 0)
        if dt == torch.float64:     # phase 17's unsharded reference
            nuts_ref = (samples, stats, nuts[name]["samples_per_sec"])
        del samples, stats
    torch.cuda.empty_cache()

    # phase 17: parallel and the kernel API; each rank counts its own
    # launches from 0 right before each of its paths
    log("parallel: starting %.1f s into the run"
        % (time.perf_counter() - t_start))
    par = phase_parallel(device, nuts_ref)
    del nuts_ref
    mesh_b = [par["b"][r]["f64"]["launches"] for r in range(P17_RANKS)]
    dw = par["kernels"]["dia_stream_width_float64"]
    dk = par["kernels"]["dia_r%d_float64" % dw]
    pred_sparse = [par["c"]["sparse"][r]["launches"]
                   for r in range(P17_RANKS)]
    for r in range(P17_RANKS):
        log("parallel main path, rank %d: leaf kernel launches %d (B %s) "
            "under HODLRSolver(mesh=) f64; DIA kernel launches %d (r %s) "
            "and CG step kernel launches %d under sharded_predict on the "
            "sparse solver"
            % (r, mesh_b[r]["leaf"], mesh_b[r]["leaf_B"],
               pred_sparse[r]["dia"], pred_sparse[r]["dia_r"],
               pred_sparse[r]["cg"]))
    sym_g = [par["g"][r]["launches"] for r in range(P17_RANKS)]
    for r in range(P17_RANKS):
        log("parallel main path, rank %d: leaf kernel launches %d (B %s) "
            "under HODLRSolver(mesh=, sym=True) f64"
            % (r, sym_g[r]["leaf"], sym_g[r]["leaf_B"]))

    # phase 18: the examples' twins, each with its own counts
    log("examples: starting %.1f s into the run"
        % (time.perf_counter() - t_start))
    ex = phase_examples(device)

    log(json.dumps({"summary": {
        "build_s": build_s, "cusolver_ms": kern["cusolver_ms"],
        "leaf_kernel": {k: v for k, v in kern.items() if "x" in k},
        "f32": f32, "f64": f64, "dia_kernel": kdia, "cg_kernel": kcg,
        "tiled_kernel": tile,
        "sparse_direct": direct, "sparse_iterative": it,
        "sparse_ell_2d": ell, "nuts_512": nuts, "hodlr_chains": chains,
        "sparse_log_prob": sparse_lp, "sym": sym, "selfcheck_knn": selfcheck,
        "lcm": lcm, "hmatrix": hm, "checkpoint": ckpt, "parallel": par,
        "examples": ex, "bench_configs": bench, "hodlr_graph": graph,
        "seconds": time.perf_counter() - t_start}}))
    r1, r16, r17 = kdia["r1"], kdia["r16"], kdia["r17"]
    # the tiled kernel's line leads with its worst shape against the library
    t, t2 = sorted((tile["8x128"], tile["1024x64"]),
                   key=lambda v: -v["ms"] / v["library_ms"])
    shapes = {id(tile["8x128"]): "(8, 128) f32",
              id(tile["1024x64"]): "(1024, 64) f32"}
    k64, k489 = kern["512x196_float64"], kern["2048x489_float32"]
    k489d = kern["2048x489_float64"]
    print(json.dumps({"kernels": [
        {"name": "leaf_cholesky", "route": "cuda",
         "source": "george_tpu_torch/csrc/chol.cu",
         "replaces": "george_tpu/ops/chol.py:154",
         "launches": launches, "max_abs_err": kern["max_abs_err"],
         "ms": kern["ms"], "plain_ms": kern["plain_ms"],
         "bound_ms": kern["bound_ms"], "bound_by": kern["bound_by"],
         "library_ms": kern["library_ms"],
         "shape": "(512, 196) f32", "launches_in": "HODLR f32 main path",
         "ms_512x196_f64": k64["ms"], "plain_ms_512x196_f64": k64["plain_ms"],
         "bound_ms_512x196_f64": k64["bound_ms"],
         "library_ms_512x196_f64": k64["library_ms"],
         "max_abs_err_512x196_f64": k64["max_abs_err"],
         "launches_f64_path": launches_f64,
         "ms_2048x489_f32": k489["ms"],
         "plain_ms_2048x489_f32": k489["plain_ms"],
         "bound_ms_2048x489_f32": k489["bound_ms"],
         "library_ms_2048x489_f32": k489["library_ms"],
         "max_abs_err_2048x489_f32": k489["max_abs_err"],
         "ms_2048x489_f64": k489d["ms"],
         "plain_ms_2048x489_f64": k489d["plain_ms"],
         "bound_ms_2048x489_f64": k489d["bound_ms"],
         "library_ms_2048x489_f64": k489d["library_ms"],
         "max_abs_err_2048x489_f64": k489d["max_abs_err"],
         "launches_bench_configs": {
             k: v["leaf_by_shape"] for k, v in bench_launches.items()},
         "launches_in_bench_configs": "phase 19, each part's own count "
                                      "by leaf shape",
         "launches_chain_batched": launches_chains,
         "chain_batched_launch_B": chains["leaf_launch_batch"],
         "launches_sym_path": launches_sym,
         "launches_lcm_path": launches_lcm,
         "launches_selfcheck_knn_path": launches_selfcheck,
         "launches_hmatrix_path": launches_hm["hmatrix_solver"],
         "launches_hmatrix_weak_comparison": launches_hm["weak_comparison"],
         "launches_mesh_per_rank": [b["leaf"] for b in mesh_b],
         "mesh_launch_B_per_rank": [b["leaf_B"] for b in mesh_b],
         "launches_in_mesh": "HODLRSolver(mesh=) f64 on 2 gloo ranks "
                             "sharing the card, each rank's own count",
         "launches_mesh_sym_per_rank": [g["leaf"] for g in sym_g],
         "mesh_sym_launch_B_per_rank": [g["leaf_B"] for g in sym_g],
         "launches_examples": {k: v["launches"]["leaf"]
                               for k, v in ex.items()
                               if isinstance(v, dict)},
         "examples_shapes": [
             {k: t[k] for k in ("B", "m", "dtype", "ms", "plain_ms",
                                "library_ms", "bound_ms", "bound_by",
                                "max_abs_err")}
             for t in ex["leaf_shapes_checked"]],
         "ms_256x196_f64": par["kernels"]["leaf_256x196_float64"]["ms"],
         "plain_ms_256x196_f64":
             par["kernels"]["leaf_256x196_float64"]["plain_ms"],
         "bound_ms_256x196_f64":
             par["kernels"]["leaf_256x196_float64"]["bound_ms"],
         "library_ms_256x196_f64":
             par["kernels"]["leaf_256x196_float64"]["library_ms"],
         "max_abs_err_256x196_f64":
             par["kernels"]["leaf_256x196_float64"]["max_abs_err"]},
        {"name": "dia_matvec", "route": "cuda",
         "source": "george_tpu_torch/csrc/dia.cu",
         "replaces": "george_tpu/ops/dia.py:96",
         "launches": dia_launches, "max_abs_err": r1["max_abs_err"],
         "ms": r1["ms"], "plain_ms": r1["plain_ms"],
         "bound_ms": r1["bound_ms"], "bound_by": r1["bound_by"],
         "library_ms": r1["library_ms"],
         "device_ms": r1["device_ms"], "operator_ms": r1["operator_ms"],
         "library_device_ms": r1["library_device_ms"],
         "shape": "n=%d D=%d r=1 f32" % (kdia["n"], kdia["D"]),
         "ms_r16": r16["ms"], "plain_ms_r16": r16["plain_ms"],
         "bound_ms_r16": r16["bound_ms"], "library_ms_r16": r16["library_ms"],
         "max_abs_err_r16": r16["max_abs_err"],
         "device_ms_r16": r16["device_ms"],
         "device_ms_r17": r17["device_ms"],
         "ms_r17": r17["ms"], "plain_ms_r17": r17["plain_ms"],
         "bound_ms_r17": r17["bound_ms"], "library_ms_r17": r17["library_ms"],
         "max_abs_err_r17": r17["max_abs_err"],
         "launches_in": "sparse iterative f32 path",
         "launches_log_prob": launches_lp,
         "launches_sharded_predict_per_rank": [c["dia"] for c in pred_sparse],
         "launches_examples": {k: v["launches"]["dia"]
                               for k, v in ex.items()
                               if isinstance(v, dict)},
         "examples_shapes": [
             {k: t[k] for k in ("n", "D", "r", "dtype", "ms", "plain_ms",
                                "library_ms", "bound_ms", "bound_by",
                                "max_abs_err")}
             for t in ex["dia_shapes_checked"]],
         "r_sharded_predict_per_rank": [c["dia_r"] for c in pred_sparse],
         "ms_r%d_f64" % dw: dk["ms"], "plain_ms_r%d_f64" % dw: dk["plain_ms"],
         "bound_ms_r%d_f64" % dw: dk["bound_ms"],
         "library_ms_r%d_f64" % dw: dk["library_ms"],
         "max_abs_err_r%d_f64" % dw: dk["max_abs_err"]},
        {"name": "cg_step", "route": "cuda",
         "source": "george_tpu_torch/csrc/cg.cu",
         "replaces": "none (XLA fused the loop body of "
                     "george_tpu/solvers/sparse.py::pcg_solve)",
         "launches": cg_launches, "max_abs_err": kcg["r1"]["max_abs_err"],
         "alpha_rel_err": kcg["r1"]["alpha_rel_err"],
         "beta_rel_err": kcg["r1"]["beta_rel_err"],
         "ms": kcg["r1"]["ms"], "plain_ms": kcg["r1"]["plain_ms"],
         "bound_ms": kcg["r1"]["bound_ms"],
         "bound_by": kcg["r1"]["bound_by"],
         "shape": "n=%d r=1 f32" % kcg["n"],
         "ms_r16": kcg["r16"]["ms"], "plain_ms_r16": kcg["r16"]["plain_ms"],
         "bound_ms_r16": kcg["r16"]["bound_ms"],
         "max_abs_err_r16": kcg["r16"]["max_abs_err"],
         "alpha_rel_err_r16": kcg["r16"]["alpha_rel_err"],
         "beta_rel_err_r16": kcg["r16"]["beta_rel_err"],
         "launches_in": "sparse iterative f32 path",
         "launches_log_prob": cg_launches_lp,
         "launches_ell_2d": cg_launches_ell,
         "launches_sharded_predict_per_rank": [c["cg"] for c in pred_sparse],
         "launches_examples": {k: v["launches"]["cg"]
                               for k, v in ex.items()
                               if isinstance(v, dict)}},
        {"name": "cholesky_tiled", "route": "cuda",
         "source": "george_tpu_torch/csrc/chol.cu",
         "replaces": "george_tpu/ops/chol.py:61",
         "launches": t["launches"], "max_abs_err": t["max_abs_err"],
         "ms": t["ms"], "plain_ms": t["plain_ms"],
         "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
         "library_ms": t["library_ms"], "shape": shapes[id(t)],
         "other_shape": shapes[id(t2)], "ms_other": t2["ms"],
         "plain_ms_other": t2["plain_ms"], "bound_ms_other": t2["bound_ms"],
         "library_ms_other": t2["library_ms"],
         "max_abs_err_other": t2["max_abs_err"],
         "launches_in": "its kernel phase's timed launches (on no solver "
                        "path)"},
    ]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--unsharded-times"]:
        unsharded_times_ab(sys.argv[2:])
    elif sys.argv[1:2] == ["--unsharded-child"]:
        _unsharded_child(sys.argv[2])
    elif sys.argv[1:2] == ["--unchunked-peak"]:
        unchunked_peak()
    elif sys.argv[1:2] == ["--cascade-dtype"]:
        cascade_dtype()
    elif sys.argv[1:2] == ["--hmatrix-memory"]:
        hmatrix_memory()
    else:
        main()
