# -*- coding: utf-8 -*-
"""Modeling framework example (the twin of ``examples/model.py``, the
reference's ``docs/tutorials/model.rst`` workflow): a non-linear mean
model (Gaussian feature) fit jointly with a GP noise model, compared
against a white-noise-only fit.

The moral of the tutorial: ignoring correlated noise biases the feature
parameters; putting a GP on the residual covariance recovers them. The
example asserts exactly that.

Run: ``python -m george_tpu_torch.examples.model [--device cpu]
[--dtype float32]``
"""

import numpy as np
import torch

from george_tpu_torch import GP, kernels
from george_tpu_torch.examples import parse_args
from george_tpu_torch.modeling import Model
from george_tpu_torch.sampling import minimize, EnsembleSampler


class GaussianFeature(Model):
    """amp * exp(-(t - location)^2 / (2 sigma^2)): the simplest
    non-linear mean model (reference ``model.rst`` "A Simple Mean
    Model")."""

    parameter_names = ("amp", "location", "log_sigma2")

    def get_value(self, t):
        return self.amp * np.exp(
            -0.5 * (t.flatten() - self.location) ** 2
            * np.exp(-self.log_sigma2)
        )

    # the same in torch ops, so the fused likelihood and the samplers
    # evaluate it on the device under torch.func
    def value_fn(self, theta, t):
        amp, loc, ls2 = theta
        return amp * torch.exp(
            -0.5 * (t.flatten() - loc) ** 2 * torch.exp(-ls2)
        )


TRUTH = dict(amp=-1.0, location=0.1, log_sigma2=np.log(0.4))


def generate_data(params, n, seed=1234, rng_lo=-5.0, rng_hi=5.0,
                  device="cuda", dtype=torch.float64):
    rng = np.random.default_rng(seed)
    gp = GP(0.1 * kernels.ExpSquaredKernel(3.3), device=device, dtype=dtype)
    t = rng_lo + (rng_hi - rng_lo) * np.sort(rng.random(n))
    np.random.seed(seed)
    y = gp.sample(t)
    y += GaussianFeature(**params).get_value(t)
    yerr = 0.05 + 0.05 * rng.random(n)
    y += yerr * rng.standard_normal(n)
    return t, y, yerr


def fit(gp, t, y, yerr, seed):
    gp.compute(t, yerr)
    minimize(gp, y)
    nw, ndim = 36, len(gp)
    rng = np.random.default_rng(seed)
    sampler = EnsembleSampler(
        nw, ndim, gp.log_prob_fn(t[:, None], y, yerr, gate_prior=False),
        device=gp.device,
    )
    sampler.run_mcmc(
        gp.get_parameter_vector()[None, :]
        + 1e-4 * rng.standard_normal((nw, ndim)),
        600, seed=seed,
    )
    return sampler.flatchain[nw * 300:]


def white_noise_gp(device="cuda", dtype=torch.float64):
    return GP(mean=GaussianFeature(
        amp=-1.0, location=0.1, log_sigma2=np.log(0.4)
    ), fit_mean=True, device=device, dtype=dtype)


def gp_noise_gp(y, device="cuda", dtype=torch.float64):
    return GP(
        np.var(y) * kernels.Matern32Kernel(10.0),
        mean=GaussianFeature(
            amp=-1.0, location=0.1, log_sigma2=np.log(0.4)
        ),
        fit_mean=True, device=device, dtype=dtype,
    )


def main(device="cuda", dtype=torch.float64):
    t, y, yerr = generate_data(TRUTH, 50, device=device, dtype=dtype)

    # --- white-noise-only fit -------------------------------------------
    gp_white = white_noise_gp(device, dtype)
    flat_w = fit(gp_white, t, y, yerr, seed=1)
    names = gp_white.get_parameter_names()
    i_loc = names.index("mean:location")
    loc_w, sd_w = flat_w[:, i_loc].mean(), flat_w[:, i_loc].std()

    # --- GP-noise fit ----------------------------------------------------
    gp_noise = gp_noise_gp(y, device, dtype)
    flat_g = fit(gp_noise, t, y, yerr, seed=2)
    names_g = gp_noise.get_parameter_names()
    j_loc = names_g.index("mean:location")
    loc_g, sd_g = flat_g[:, j_loc].mean(), flat_g[:, j_loc].std()

    print("white-noise model: location = %.3f +/- %.3f" % (loc_w, sd_w))
    print("GP-noise model:    location = %.3f +/- %.3f  (truth %.3f)"
          % (loc_g, sd_g, TRUTH["location"]))

    # the GP-noise posterior must cover the truth within ~2.5 sigma and
    # acknowledge more uncertainty than the overconfident white-noise fit
    assert abs(loc_g - TRUTH["location"]) < 2.5 * sd_g + 0.05
    assert sd_g > sd_w * 0.8
    print("model example OK")
    return {"loc_white": float(loc_w), "sd_white": float(sd_w),
            "loc_gp": float(loc_g), "sd_gp": float(sd_g)}


if __name__ == "__main__":
    args = parse_args()
    main(args.device, args.dtype)
