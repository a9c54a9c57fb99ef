# -*- coding: utf-8 -*-
"""Spatial (2-D) GP regression with the strong-admissibility solver (the
twin of ``examples/spatial.py``).

For genuinely spatial data the H-matrix partition (``solvers/hmatrix.py``)
keeps the near field exact, compresses well-separated interactions and
solves by preconditioned CG. This example fits a 2-D field and asserts two
things:

1. the posterior mean recovers the field well under the noise level, and
2. at the SAME skeleton rank, the strong partition's likelihood is at
   least an order of magnitude closer to the exact answer than the weak
   (HODLR) one — the reason the solver exists.

Run: ``python -m george_tpu_torch.examples.spatial [n] [--device cpu]
[--dtype float32]``
"""

import numpy as np
import torch

from george_tpu_torch import GP, kernels
from george_tpu_torch.examples import parse_args
from george_tpu_torch.solvers import BasicSolver, HODLRSolver, HMatrixSolver


def generate_data(n):
    """``(x, y, yerr, rng)``: the field's points, the noisy field, its
    noise, and the stream the test points are drawn from next."""
    rng = np.random.default_rng(7)
    x = rng.uniform(0, 12, (n, 2))
    truth = np.sin(x[:, 0]) * np.cos(0.7 * x[:, 1])
    y = truth + 0.1 * rng.standard_normal(n)
    yerr = 0.1 * np.ones(n)
    return x, y, yerr, rng


def spatial_kernel():
    return 1.0 * kernels.ExpSquaredKernel([1.5, 1.5], ndim=2)


def main(n=2000, device="cuda", dtype=torch.float64):
    x, y, yerr, rng = generate_data(n)
    kernel = spatial_kernel()

    gp = GP(kernel, solver=HMatrixSolver, min_size=64, rank=16,
            precond_rank=64, device=device, dtype=dtype)
    gp.compute(x, yerr=yerr)
    ll = gp.log_likelihood(y)
    print("strong-admissibility log-likelihood: %.4f" % ll)

    t = rng.uniform(1, 11, (400, 2))
    mu, var = gp.predict(y, t, return_var=True)
    ft = np.sin(t[:, 0]) * np.cos(0.7 * t[:, 1])
    rmse = float(np.sqrt(np.mean((mu - ft) ** 2)))
    cover = float(np.mean(np.abs(mu - ft) <= 2 * np.sqrt(var) + 1e-12))
    print("prediction RMSE %.4f (noise 0.1), 2-sigma coverage %.2f"
          % (rmse, cover))
    assert rmse < 0.1
    assert cover > 0.9

    # exact reference + the weak partition at the same rank
    gp_exact = GP(kernel, solver=BasicSolver, device=device, dtype=dtype)
    gp_exact.compute(x, yerr=yerr)
    ll_exact = gp_exact.log_likelihood(y)
    gp_weak = GP(kernel, solver=HODLRSolver, min_size=64, rank=16,
                 device=device, dtype=dtype)
    gp_weak.compute(x, yerr=yerr)
    ll_weak = gp_weak.log_likelihood(y)

    err_strong = abs(ll - ll_exact) / abs(ll_exact)
    err_weak = abs(ll_weak - ll_exact) / abs(ll_exact)
    print("|ll - exact|/|exact|: strong %.2e  weak %.2e (rank 16 both)"
          % (err_strong, err_weak))
    # the strong-partition likelihood error floor is the SLQ logdet
    # correction's Monte-Carlo noise (~1e-4 relative at default probes)
    assert err_strong < 5e-4
    assert err_strong < 0.1 * err_weak
    print("OK")
    st = gp_weak.solver._struct
    return {"ll": ll, "ll_exact": ll_exact, "ll_weak": ll_weak,
            "rmse": rmse, "coverage": cover, "err_strong": err_strong,
            "err_weak": err_weak, "weak_leaves": [st.n_pad // st.m, st.m]}


if __name__ == "__main__":
    args = parse_args(positional=[("n", int, 2000)])
    main(args.n, args.device, args.dtype)
