# -*- coding: utf-8 -*-
"""First-steps example (the twin of ``examples/first.py``, the reference's
``docs/tutorials/first.rst`` workflow): noisy quasi-periodic data, a
composite kernel, likelihood optimization and posterior prediction.

Run: ``python -m george_tpu_torch.examples.first [--device cpu]
[--dtype float32]``
"""

import numpy as np
import torch

from george_tpu_torch import GP, kernels
from george_tpu_torch.examples import parse_args
from george_tpu_torch.sampling import minimize


def generate_data(n=60, seed=1234):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0, 10, n))
    yerr = 0.05 + 0.05 * rng.uniform(size=n)
    y = np.sin(x) + yerr * rng.standard_normal(n)
    return x, y, yerr


def main(device="cuda", dtype=torch.float64):
    x, y, yerr = generate_data()

    kernel = np.var(y) * kernels.ExpSquaredKernel(0.5)
    gp = GP(kernel, device=device, dtype=dtype)
    gp.compute(x, yerr)
    ll0 = gp.log_likelihood(y)
    print("Initial log-likelihood: {0:.3f}".format(ll0))

    result = minimize(gp, y)
    print("Optimized parameters:", dict(zip(
        gp.get_parameter_names(), gp.get_parameter_vector()
    )))
    ll = gp.log_likelihood(y)
    print("Final log-likelihood: {0:.3f}".format(ll))

    t = np.linspace(0, 10, 500)
    mu, var = gp.predict(y, t, return_var=True)
    rmse = np.sqrt(np.mean((mu - np.sin(t)) ** 2))
    print("Prediction RMSE vs truth: {0:.4f}".format(rmse))
    assert result.success or np.isfinite(result.fun)
    return {"ll0": ll0, "ll": ll, "rmse": float(rmse)}


if __name__ == "__main__":
    args = parse_args()
    main(args.device, args.dtype)
