"""The log-posterior's value and gradient at parameters drawn around the
configuration's own, as ``minimize`` and the samplers ask for them:
``torch.func.grad_and_value(gp.log_prob_fn(x, y, yerr))``, over
``chains`` chains at once through ``torch.func.vmap`` when the mix has
more than one. Each call's parameters are new; its value and gradient are
read to the host before the next call starts.

Mix parameters: ``chains``, ``theta_sd`` (the spread, in the log
parameters, around the configuration's vector)."""

import numpy as np
import torch


def draw(rng, cell, count):
    chains = cell.traffic["chains"]
    shape = (count, len(cell.theta0)) if chains == 1 else \
        (count, chains, len(cell.theta0))
    theta = cell.theta0 + cell.traffic["theta_sd"] * rng.standard_normal(
        shape)
    return list(theta)


def make_call(gp, cell):
    d = cell.data
    f = torch.func.grad_and_value(gp.log_prob_fn(d.x, d.y, d.yerr))
    if cell.traffic["chains"] > 1:
        f = torch.func.vmap(f)
    dtype, device = gp.dtype, gp.device

    def call(theta):
        g, v = f(torch.as_tensor(theta, dtype=dtype, device=device))
        return (np.atleast_1d(v.cpu().numpy()).astype(np.float64),
                np.atleast_2d(g.cpu().numpy()).astype(np.float64))

    return call


def finite(out):
    return bool(np.all(np.isfinite(out[0])) and np.all(np.isfinite(out[1])))


def reference(ref, cell, inputs):
    method = cell.config["reference"]["method"]
    out = []
    for theta in inputs:
        values, grads = [], []
        for th in np.atleast_2d(theta):
            full = cell.full_theta(th)
            if method == "exact":
                v, g = ref.loglike_and_grad(full, cell.data.y)
            else:
                v, g = ref.slq_loglike_and_grad(
                    full, cell.data.y, cell.solver_inputs["probes"],
                    cell.config["solver"]["options"]["num_steps"])
            values.append(v)
            grads.append(g[cell.active])
        out.append((np.array(values), np.array(grads)))
    return out


def gaps(outputs, expected):
    """``value_gap``: the largest ``|v - v_ref| / |v_ref|``;
    ``grad_gap``: the largest ``max|g - g_ref| / max|g_ref|`` of one
    evaluation (one chain's gradient)."""
    vg, gg = 0.0, 0.0
    for (v, g), (vr, gr) in zip(outputs, expected):
        vg = max(vg, float(np.max(np.abs(v - vr) / np.abs(vr))))
        gg = max(gg, float(np.max(np.max(np.abs(g - gr), axis=1)
                                  / np.max(np.abs(gr), axis=1))))
    return {"value_gap": vg, "grad_gap": gg}
