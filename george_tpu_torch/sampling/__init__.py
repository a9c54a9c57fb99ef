# -*- coding: utf-8 -*-
"""Hyperparameter inference engines (PyTorch port of
``george_tpu/sampling``), all driven by ``GP.log_prob_fn``:

* :mod:`ensemble` — affine-invariant stretch-move MCMC (emcee semantics),
  every walker of a half-sweep in one batched evaluation;
* :mod:`hmc` — HMC and NUTS with window adaptation over batched chains;
* :mod:`optimize` — scipy L-BFGS-B and Adam over the fused value and
  gradient;
* :mod:`vi` — mean-field and full-rank ADVI.

Each takes a ``torch.Generator`` or an int seed where the JAX package takes
a ``PRNGKey``, and runs on the device of the tensors it is given (arrays
go to ``device``, default ``"cuda"``).
"""

from .ensemble import EnsembleSampler, run_ensemble, ensemble_step
from .hmc import NUTS, HMC, sample_nuts, sample_hmc
from .optimize import minimize, fit_adam
from .vi import ADVI, fit_advi, fit_advi_fullrank, advi_sample

__all__ = ["EnsembleSampler", "run_ensemble", "ensemble_step",
           "NUTS", "HMC", "sample_nuts", "sample_hmc",
           "minimize", "fit_adam",
           "ADVI", "fit_advi", "fit_advi_fullrank", "advi_sample"]
