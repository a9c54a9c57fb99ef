# -*- coding: utf-8 -*-
"""Hyperparameter inference example (the twin of ``examples/hyper.py``,
the reference's ``docs/tutorials/hyper.rst``): maximum likelihood,
ensemble MCMC (the emcee pattern), NUTS, and variational inference on the
same posterior.

Run: ``python -m george_tpu_torch.examples.hyper [--smoke] [--device cpu]
[--dtype float32]`` (``--smoke``: the reduced iteration counts of the
JAX example's CI smoke test).
"""

import numpy as np
import torch

from george_tpu_torch import GP, kernels
from george_tpu_torch.examples import parse_args
from george_tpu_torch.sampling import (
    minimize, EnsembleSampler, sample_nuts, ADVI,
)


def generate_data():
    rng = np.random.default_rng(42)
    x = np.sort(rng.uniform(0, 10, 80))
    yerr = 0.1
    y = np.sin(x) * np.exp(-0.1 * x) + yerr * rng.standard_normal(80)
    return x, y, yerr, rng


def main(smoke=False, device="cuda", dtype=torch.float64):
    n_ens, n_nuts_w, n_nuts_s, n_advi = (
        (200, 120, 150, 400) if smoke else (800, 400, 500, 1500)
    )
    x, y, yerr, rng = generate_data()

    gp = GP(np.var(y) * kernels.Matern52Kernel(1.0), device=device,
            dtype=dtype)
    gp.compute(x, yerr)

    # --- maximum likelihood ---------------------------------------------
    minimize(gp, y)
    print("MAP parameters:", gp.get_parameter_vector())

    # The pure posterior surface every engine consumes. The smooth prior
    # makes the posterior proper (a bare GP marginal likelihood plateaus
    # at the noise-only model for runaway amplitudes/scales) — the
    # reference's tutorial composes a prior into lnprob the same way
    # (hyper.rst).
    center = torch.as_tensor(gp.get_parameter_vector(), device=device,
                             dtype=dtype)

    def log_prior(th):
        return -0.5 * torch.sum(((th - center) / 3.0) ** 2)

    log_prob = gp.log_prob_fn(x, y, yerr, gate_prior=False,
                              log_prior=log_prior)
    ndim = len(gp)
    p0 = gp.get_parameter_vector()[None, :]

    # --- ensemble MCMC (emcee pattern, fused) ---------------------------
    nw = 32
    sampler = EnsembleSampler(nw, ndim, log_prob, device=device)
    sampler.run_mcmc(
        p0 + 1e-3 * rng.standard_normal((nw, ndim)), n_ens, seed=0
    )
    flat_ens = sampler.flatchain[nw * (n_ens // 2):]
    print("ensemble posterior mean:", flat_ens.mean(axis=0),
          "sd:", flat_ens.std(axis=0))

    # --- NUTS (dense mass: GP posteriors are correlated) ------------------
    samples, stats = sample_nuts(
        1, log_prob, p0 + 1e-3 * rng.standard_normal((8, ndim)),
        num_warmup=n_nuts_w, num_samples=n_nuts_s, dense_mass=True,
        device=device,
    )
    flat_nuts = samples.cpu().numpy().reshape(-1, ndim)
    print("NUTS posterior mean:    ", flat_nuts.mean(axis=0),
          "sd:", flat_nuts.std(axis=0),
          "accept: %.2f" % float(torch.mean(stats["accept"])))

    # --- variational (full-rank: captures posterior correlations) --------
    advi = ADVI(log_prob, num_steps=n_advi, full_rank=True, device=device)
    mu, sigma = advi.fit(gp.get_parameter_vector(), seed=2)
    print("ADVI posterior mean:    ", mu, "sd:", sigma)

    # the three engines agree on the posterior location
    assert np.allclose(flat_ens.mean(0), flat_nuts.mean(0), atol=0.2)
    assert np.allclose(mu, flat_nuts.mean(0), atol=0.4)
    print("all inference engines agree")
    return {"ensemble_mean": flat_ens.mean(0), "nuts_mean": flat_nuts.mean(0),
            "advi_mean": mu, "map": gp.get_parameter_vector()}


if __name__ == "__main__":
    args = parse_args(flags=["smoke"])
    main(args.smoke, args.device, args.dtype)
