"""Sorted uniform 1-D inputs and a noisy sine, drawn from one numpy
generator (``numpy.random.default_rng(seed)``) in this order: ``x`` (``n``
uniform draws on ``[0, high)``, then sorted), ``discard`` standard normal
vectors of length ``n`` that the published recipe draws and uses for
something else, then the noise of ``y = sin(freq * x) + noise_sd * N(0, 1)``.
``yerr`` is the same for every point.

With ``x_seed``, ``x`` is drawn from ``numpy.random.default_rng(x_seed)``
instead (the run's generator draws and drops as many uniforms), so every
run has the same inputs, and with them the same sizes (a compact kernel's
band), while ``y`` still comes from the run's generator; at
``seed == x_seed`` the data are the published stream's."""

import numpy as np


def make(rng, n, high, freq, noise_sd, yerr, discard=0, x_seed=None):
    x = np.sort(rng.uniform(0, high, n))
    if x_seed is not None:
        x = np.sort(np.random.default_rng(x_seed).uniform(0, high, n))
    for _ in range(discard):
        rng.standard_normal(n)
    y = np.sin(freq * x) + noise_sd * rng.standard_normal(n)
    return x, y, np.full(n, float(yerr)), (0.0, float(high))
