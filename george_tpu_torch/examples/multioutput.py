# -*- coding: utf-8 -*-
"""Multi-output GP with the linear coregionalization (LCM) kernel (the
twin of ``examples/multioutput.py``; the GPTune fork's flagship addition).

Two correlated tasks observe shifted/scaled versions of one latent
function; the LCM kernel transfers strength between them. The task id
rides in the last input coordinate.

The second part runs the same model AT SCALE (default n=10,000 across two
tasks) through the hierarchical solver.

Run: ``python -m george_tpu_torch.examples.multioutput [n_at_scale]
[--device cpu] [--dtype float32]``
"""

import time

import numpy as np
import torch

from george_tpu_torch import GP, kernels
from george_tpu_torch.examples import parse_args
from george_tpu_torch.sampling import minimize
from george_tpu_torch.solvers import HODLRSolver


def generate_data():
    """The two tasks' data: ``(x, y)`` with the task id in the last column
    of ``x``, task 1's offset removed."""
    rng = np.random.default_rng(7)
    n_per = 40
    xs = np.sort(rng.uniform(0, 10, n_per))
    latent = np.sin(xs)
    y0 = 1.0 * latent + 0.05 * rng.standard_normal(n_per)
    y1 = 0.6 * latent + 0.3 + 0.05 * rng.standard_normal(n_per)

    # inputs: (coordinate, task id)
    x = np.concatenate(
        [
            np.stack([xs, np.zeros(n_per)], axis=1),
            np.stack([xs, np.ones(n_per)], axis=1),
        ]
    )
    y = np.concatenate([y0, y1 - 0.3])   # remove task-1 offset for brevity
    return x, y


def lcm_kernel():
    return kernels.LCMKernel(
        logBK=np.log([1.0, 0.6, 0.1, 0.1]),   # B (T x Q) then K (T x Q)
        children=[kernels.ExpSquaredKernel(metric=1.0)],
        T=2, Q=1, ndim=1,
    )


def main(n_at_scale=10000, device="cuda", dtype=torch.float64):
    x, y = generate_data()
    gp = GP(lcm_kernel(), device=device, dtype=dtype)
    gp.compute(x, 0.05)
    out = {"ll0": gp.log_likelihood(y)}
    print("initial log-likelihood: {0:.2f}".format(out["ll0"]))
    minimize(gp, y)
    out["ll"] = gp.log_likelihood(y)
    print("fitted  log-likelihood: {0:.2f}".format(out["ll"]))

    # predict task 1 from both tasks' data
    t = np.linspace(0, 10, 100)
    t1 = np.stack([t, np.ones_like(t)], axis=1)
    mu1, var1 = gp.predict(y, t1, return_var=True)
    rmse = out["rmse"] = float(np.sqrt(np.mean((mu1 - 0.6 * np.sin(t)) ** 2)))
    print("task-1 prediction RMSE vs truth: {0:.4f}".format(rmse))
    assert rmse < 0.15
    # cross-task transfer: task-1 posterior tighter than its noise-only
    # baseline thanks to shared structure
    assert np.median(np.sqrt(var1)) < 0.2

    out["at_scale"] = at_scale(n_at_scale, device, dtype)
    return out


def at_scale_problem(n_total):
    """The at-scale model and data: ``(x, y, yerr, kernel)``, ``x`` the
    coordinate and the task id."""
    rng = np.random.default_rng(11)
    n_per = n_total // 2
    xs = np.sort(rng.uniform(0, 200.0, n_per))
    latent = np.sin(0.3 * xs)
    y0 = 1.0 * latent + 0.1 * rng.standard_normal(n_per)
    y1 = 0.6 * latent + 0.1 * rng.standard_normal(n_per)
    x = np.concatenate(
        [
            np.stack([xs, np.zeros(n_per)], axis=1),
            np.stack([xs, np.ones(n_per)], axis=1),
        ]
    )
    y = np.concatenate([y0, y1])

    kernel = kernels.LCMKernel(
        logBK=np.log([1.0, 0.6, 0.05, 0.05]),
        children=[kernels.ExpSquaredKernel(metric=10.0)],
        T=2, Q=1, ndim=1,
    )
    return x, y, 0.1, kernel


def at_scale(n_total, device="cuda", dtype=torch.float64):
    """The same multi-task model at scale through the hierarchical
    solver. The solver orders on the spatial axes only
    (``LCMKernel.sort_axes``), so the coarse off-diagonal blocks stay
    low-rank with tasks interleaved."""
    x, y, yerr, kernel = at_scale_problem(n_total)
    # rank 48: the densely-sampled very-smooth covariance here is
    # ill-conditioned, and prediction amplifies solve error (rank 24
    # predicts at RMSE 0.099, rank 48 at 0.010)
    gp = GP(kernel, solver=HODLRSolver, min_size=128, rank=48,
            device=device, dtype=dtype)
    t0 = time.perf_counter()
    gp.compute(x, yerr)
    ll = gp.log_likelihood(y)
    dt = time.perf_counter() - t0
    print(
        "at-scale n={0}: hierarchical LCM log-likelihood {1:.2f} "
        "({2:.1f} s compute+eval)".format(n_total, ll, dt)
    )
    assert np.isfinite(ll)

    # cross-task prediction: task 1 at held-out points, learned from
    # both tasks
    t = np.linspace(5, 195, 200)
    t1 = np.stack([t, np.ones_like(t)], axis=1)
    mu1 = gp.predict(y, t1, return_cov=False)
    rmse = float(np.sqrt(np.mean((mu1 - 0.6 * np.sin(0.3 * t)) ** 2)))
    print("at-scale task-1 prediction RMSE vs truth: {0:.4f}".format(rmse))
    assert rmse < 0.05
    return {"ll": ll, "rmse": rmse, "seconds": dt}


if __name__ == "__main__":
    args = parse_args(positional=[("n_at_scale", int, 10000)])
    main(args.n_at_scale, args.device, args.dtype)
