# -*- coding: utf-8 -*-
"""Bayesian optimization with a GP surrogate (the twin of
``examples/bayesopt.py``; reference ``docs/tutorials/bayesopt.rst``, after
Jones et al. 1998 §4.1).

The loop: seed the surrogate with a few objective evaluations, refit the
GP hyperparameters by maximum likelihood, pick the next evaluation point
by maximizing expected improvement (EI), and repeat until the estimated
minimizer stops moving. The acquisition sweep's posterior mean and
variance over the candidate grid are one ``gp.predict`` on the device.

Run: ``python -m george_tpu_torch.examples.bayesopt [--device cpu]
[--dtype float32]``
"""

import numpy as np
import torch

from george_tpu_torch import GP, kernels
from george_tpu_torch.examples import parse_args
from george_tpu_torch.sampling import minimize


def objective(theta):
    """The double-well scalar objective of the reference tutorial."""
    return (
        -0.5 * np.exp(-0.5 * (theta - 2.0) ** 2)
        - 0.5 * np.exp(-0.5 * (theta + 2.1) ** 2 / 5.0)
        + 0.3
    )


def expected_improvement(mu, var, f_best):
    """EI(t) = (f* - mu) Phi(chi) + sigma phi(chi), chi = (f* - mu)/sigma."""
    from scipy.special import erf

    std = np.sqrt(np.maximum(var, 1e-16))
    chi = (f_best - mu) / std
    Phi = 0.5 * (1.0 + erf(chi / np.sqrt(2.0)))
    phi = np.exp(-0.5 * chi ** 2) / np.sqrt(2.0 * np.pi)
    return (f_best - mu) * Phi + std * phi


def bayes_opt(objective, lo=-5.0, hi=5.0, n_init=4, n_grid=5000,
              max_iter=30, rtol=1e-5, verbose=True, device="cuda",
              dtype=torch.float64):
    """Minimize ``objective`` on [lo, hi]; returns (argmin, n_evals,
    history)."""
    grid = np.linspace(lo, hi, n_grid)
    train_t = np.linspace(lo, hi, n_init + 1)[1:]
    train_t -= 0.5 * (train_t[1] - train_t[0])
    train_f = objective(train_t)

    est_min, history = None, []
    for it in range(max_iter):
        gp = GP(np.var(train_f) * kernels.Matern52Kernel(3.0),
                fit_mean=True, device=device, dtype=dtype)
        gp.compute(train_t)
        minimize(gp, train_f)

        mu, var = gp.predict(train_f, grid, return_var=True)
        acq = expected_improvement(mu, var, np.min(train_f))
        t_next = grid[int(np.argmax(acq))]

        train_t = np.append(train_t, t_next)
        train_f = np.append(train_f, objective(t_next))

        new_min = grid[int(np.argmin(mu))]
        history.append(new_min)
        if verbose:
            print("step {0:2d}: eval at {1:+.4f}, est. min {2:+.4f}".format(
                it + 1, t_next, new_min))
        if est_min is not None and abs(new_min - est_min) < rtol * max(
            1.0, abs(new_min)
        ):
            est_min = new_min
            break
        est_min = new_min
    return est_min, len(train_t), history


def main(device="cuda", dtype=torch.float64):
    est_min, n_evals, _ = bayes_opt(objective, device=device, dtype=dtype)
    grid = np.linspace(-5, 5, 200001)
    true_min = grid[int(np.argmin(objective(grid)))]
    print("estimated minimizer: {0:+.5f}  (true {1:+.5f}), "
          "{2} objective evaluations".format(est_min, true_min, n_evals))

    # the surrogate loop must find the global minimum (the deeper right
    # well, not the wide left one) with far fewer evaluations than the
    # 5000-point grid it searches over
    assert abs(est_min - true_min) < 0.05, (est_min, true_min)
    assert n_evals <= 34
    print("bayesopt example OK")
    return {"est_min": float(est_min), "true_min": float(true_min),
            "n_evals": n_evals}


if __name__ == "__main__":
    args = parse_args()
    main(args.device, args.dtype)
