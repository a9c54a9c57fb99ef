"""The posterior predictive mean and variance at new test points, at the
configuration's own parameters: ``gp.predict(y, t, return_var=True)``
after ``compute`` (the solve of ``y`` is cached by the first call, made
in set-up). Each call's points are new.

Mix parameters: ``test_points`` (per call, uniform over the data's
domain)."""

import numpy as np


def draw(rng, cell, count):
    lo, hi = cell.data.domain
    return list(rng.uniform(lo, hi, (count, cell.traffic["test_points"])))


def make_call(gp, cell):
    y = cell.data.y

    def call(t):
        mu, var = gp.predict(y, t, return_var=True)
        return np.asarray(mu, np.float64), np.asarray(var, np.float64)

    return call


def finite(out):
    return bool(np.all(np.isfinite(out[0])) and np.all(np.isfinite(out[1])))


def reference(ref, cell, inputs):
    predict = ref.predictor(cell.full_theta(cell.theta0), cell.data.y)
    return [predict(t) for t in inputs]


def gaps(outputs, expected):
    """``mean_gap``: the largest ``max|mu - mu_ref| / max|mu_ref|`` of a
    call; ``var_gap``: the same for the variance."""
    mg, vg = 0.0, 0.0
    for (mu, var), (mr, vr) in zip(outputs, expected):
        mg = max(mg, float(np.max(np.abs(mu - mr)) / np.max(np.abs(mr))))
        vg = max(vg, float(np.max(np.abs(var - vr)) / np.max(np.abs(vr))))
    return {"mean_gap": mg, "var_gap": vg}
