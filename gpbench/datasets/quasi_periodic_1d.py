"""Sorted uniform 1-D inputs and a noisy quasi-periodic signal, drawn from
one numpy generator in this order: ``x`` (``n`` uniform draws on ``[0,
high)``, then sorted), then the noise of ``y = sin(2 pi x / period)
cos(envelope_freq x) + noise_sd * N(0, 1)``. ``yerr`` is the same for
every point."""

import numpy as np


def make(rng, n, high, period, envelope_freq, noise_sd, yerr):
    x = np.sort(rng.uniform(0, high, n))
    y = (np.sin(2 * np.pi * x / period) * np.cos(envelope_freq * x)
         + noise_sd * rng.standard_normal(n))
    return x, y, np.full(n, float(yerr)), (0.0, float(high))
