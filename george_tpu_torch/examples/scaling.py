# -*- coding: utf-8 -*-
"""Large-N example (the twin of ``examples/scaling.py``, the reference's
``docs/tutorials/scaling.rst`` + hodlr tutorial): the hierarchical solver
against the exact one, and the compact-support sparse path.

Run: ``python -m george_tpu_torch.examples.scaling [n] [--device cpu]
[--dtype float32]``
"""

import numpy as np
import torch

from george_tpu_torch import GP, kernels, HODLRSolver, SparseSolver
from george_tpu_torch.examples import parse_args


def generate_data(n):
    rng = np.random.default_rng(1234)
    x = np.sort(rng.uniform(0, 100, n))
    yerr = 0.3
    y = np.sin(0.5 * x) + yerr * rng.standard_normal(n)
    return x, y, yerr


def main(n=2000, device="cuda", dtype=torch.float64):
    x, y, yerr = generate_data(n)
    out = {}

    kernel = 1.0 * kernels.ExpSquaredKernel(4.0) + 0.3 * (
        kernels.Matern32Kernel(2.0)
    )

    gp_h = GP(1.0 * kernels.ExpSquaredKernel(4.0)
              + 0.3 * kernels.Matern32Kernel(2.0),
              solver=HODLRSolver, min_size=64, rank=48, device=device,
              dtype=dtype)
    gp_h.compute(x, yerr)
    ll_h = out["ll_hodlr"] = gp_h.log_likelihood(y)
    print("HODLR   log-likelihood: {0:.4f}".format(ll_h))

    if n <= 4000:
        gp_b = GP(kernel, device=device, dtype=dtype)
        gp_b.compute(x, yerr)
        ll_b = out["ll_exact"] = gp_b.log_likelihood(y)
        print("exact   log-likelihood: {0:.4f}  (|diff| = {1:.2e})".format(
            ll_b, abs(ll_b - ll_h)
        ))
        # float64: solver parity to ~1e-7. float32: BOTH solvers carry
        # ~1e-4-level rounding, so their DIFFERENCE sits at the float32
        # floor
        tol = 1e-4 if dtype == torch.float64 else 5e-4
        assert abs(ll_b - ll_h) / abs(ll_b) < tol

    # compact support: Wendland-tapered kernel + sparse solver. Sorted
    # 1-D data is banded, so this factors EXACTLY (block-tridiagonal
    # Cholesky, solvers/banded.py) — the sparse-direct semantics of the
    # reference's SuperLU backend, no CG/SLQ noise.
    tapered = kernels.WendlandC2Kernel(
        log_rc=np.log(8.0),
        kernel_base=1.0 * kernels.ExpSquaredKernel(4.0),
    )
    gp_s = GP(tapered, solver=SparseSolver, device=device, dtype=dtype)
    gp_s.compute(x, yerr)
    ll_s = out["ll_sparse"] = gp_s.log_likelihood(y)
    out["direct"] = gp_s.solver._direct_loglike is not None
    print("sparse  log-likelihood: {0:.4f}  (nnz fraction {1:.3f}, "
          "direct={2})".format(ll_s, gp_s.solver.nnz / n ** 2,
                               out["direct"]))
    if out["direct"] and n <= 3000:
        # the direct path is exact: cross-check against a dense solve of
        # the SAME tapered covariance
        gp_sd = GP(tapered, device=device, dtype=dtype)
        gp_sd.compute(x, yerr)
        out["ll_sparse_dense"] = gp_sd.log_likelihood(y)
        assert abs(ll_s - out["ll_sparse_dense"]) < 1e-6 * abs(ll_s)

    # gradient through the hierarchical path (one autodiff sweep)
    g = out["grad_hodlr"] = gp_h.grad_log_likelihood(y)
    print("HODLR   gradient:", g)
    assert np.all(np.isfinite(g))
    return out


if __name__ == "__main__":
    args = parse_args(positional=[("n", int, 2000)])
    main(args.n, args.device, args.dtype)
