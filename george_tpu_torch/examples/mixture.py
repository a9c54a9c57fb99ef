# -*- coding: utf-8 -*-
"""Mixture-of-GPs example (the twin of ``examples/mixture.py``, the
reference's ``docs/tutorials/mixture.rst`` workflow): model a dataset as
the sum of a 2-D systematics GP and a 1-D quasi-periodic signal GP, then
use the ``kernel=`` override of ``predict`` to extract each component's
posterior mean separately:

    mu_1 = K_1 (K_1 + K_2 + N)^{-1} y.

The example asserts the separation actually works: the recovered signal
component correlates with the injected oscillation far better than the
raw data does.

Run: ``python -m george_tpu_torch.examples.mixture [--device cpu]
[--dtype float32]``
"""

import numpy as np
import torch

from george_tpu_torch import GP, kernels
from george_tpu_torch.examples import parse_args
from george_tpu_torch.sampling import minimize


def generate_data(device="cuda", dtype=torch.float64):
    """``(X, y, yerr, sig_part)``: the inputs ``(t, theta)``, the data,
    its noise and the injected signal component."""
    rng = np.random.default_rng(42)
    n = 256
    t = np.sort(rng.uniform(0, 10, n))
    theta = rng.uniform(-np.pi, np.pi, n)
    X = np.vstack((t, theta)).T
    yerr = rng.uniform(0.05, 0.25, n)

    # component 1: systematics over (t, theta); component 2: 1-D
    # quasi-periodic oscillation in t only (subspace via axes=)
    k_sys = 2.0 * kernels.Matern32Kernel([5.0, 0.5], ndim=2)
    k_sig = (
        2.0 * kernels.ExpSine2Kernel(
            gamma=10.0, log_period=np.log(5.0), ndim=2, axes=0
        )
        * kernels.ExpSquaredKernel([15.0], ndim=2, axes=0)
    )

    # draw each component separately so the recovery can be scored
    # against the injected signal (a sum-GP draw is distributionally the
    # sum of independent component draws)
    np.random.seed(7)
    sys_part = GP(k_sys, device=device, dtype=dtype).sample(X)
    np.random.seed(8)
    sig_part = GP(k_sig, device=device, dtype=dtype).sample(X)
    y = sys_part + sig_part + yerr * rng.standard_normal(n)
    return X, y, yerr, sig_part


def mixture_kernel():
    return (
        2.0 * kernels.Matern32Kernel([5.0, 0.5], ndim=2)
        + 2.0 * kernels.ExpSine2Kernel(
            gamma=10.0, log_period=np.log(5.0), ndim=2, axes=0
        )
        * kernels.ExpSquaredKernel([15.0], ndim=2, axes=0)
    )


def main(device="cuda", dtype=torch.float64):
    X, y, yerr, sig_part = generate_data(device, dtype)

    # fit the mixture
    gp = GP(mixture_kernel(), device=device, dtype=dtype)
    gp.compute(X, yerr)
    minimize(gp, y)

    # component extraction through the kernel override
    k1_fit, k2_fit = gp.kernel.models["k1"], gp.kernel.models["k2"]
    mu_sys = gp.predict(y, X, return_cov=False, kernel=k1_fit)
    mu_sig = gp.predict(y, X, return_cov=False, kernel=k2_fit)

    # the two component means add up to the full posterior mean
    mu_full = gp.predict(y, X, return_cov=False)
    assert np.allclose(mu_sys + mu_sig, mu_full, atol=1e-6)

    def corr(a, b):
        a = a - a.mean()
        b = b - b.mean()
        return float(a @ b / np.sqrt((a @ a) * (b @ b)))

    c_raw = corr(y, sig_part)
    c_rec = corr(mu_sig, sig_part)
    print("corr(raw data, signal)      = %.3f" % c_raw)
    print("corr(recovered, signal)     = %.3f" % c_rec)
    # the extracted component must track the injection better than the
    # systematics-contaminated raw data does
    assert c_rec > 0.9 and c_rec > c_raw
    print("mixture example OK")
    return {"corr_raw": c_raw, "corr_recovered": c_rec}


if __name__ == "__main__":
    args = parse_args()
    main(args.device, args.dtype)
