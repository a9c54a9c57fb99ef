# -*- coding: utf-8 -*-
"""MAP hyperparameter optimization (PyTorch port of
``george_tpu/sampling/optimize.py``; the george pattern is
``scipy.optimize.minimize`` on ``gp.nll``/``gp.grad_nll``).

* :func:`minimize` — scipy L-BFGS-B on the value and gradient of
  ``GP.log_prob_fn`` (one fused evaluation per line-search step), or on
  ``gp.nll``/``gp.grad_nll`` for models that cannot be traced;
* :func:`fit_adam` — Adam ascent on the device, from one start or a batch
  of starts evaluated together through ``torch.func.vmap``.
"""

import numpy as np
import torch

__all__ = ["minimize", "fit_adam"]


def minimize(gp, y, x=None, yerr=None, method="L-BFGS-B", bounds=None,
             **kwargs):
    """Optimize the GP's active parameters by maximum (penalized)
    likelihood. Updates ``gp`` in place and returns the scipy result.

    Uses the fused value and gradient of ``gp.log_prob_fn`` (bounds gated)
    when the mean and white-noise models are traceable, else
    ``gp.nll``/``gp.grad_nll``.
    """
    import scipy.optimize as op

    if not gp.computed:
        raise RuntimeError("You need to compute the model first")
    if x is None:
        x = gp._x
    y = np.asarray(y, dtype=np.float64)

    if gp._traceable:
        yerr_arg = np.sqrt(gp._yerr2) if yerr is None else yerr
        vag = torch.func.grad_and_value(
            gp.log_prob_fn(x, y, yerr_arg, gate_prior=True))

        def objective(vector):
            g, ll = vag(torch.as_tensor(vector, dtype=gp.dtype,
                                        device=gp.device))
            ll = float(ll)
            if not np.isfinite(ll):
                return np.inf, np.zeros_like(vector)
            return -ll, -g.detach().cpu().numpy().astype(np.float64)
    else:
        def objective(vector):
            return gp.nll(vector, y), gp.grad_nll(vector, y)

    if bounds is None:
        raw = gp.get_parameter_bounds()
        if any(b != (None, None) for b in raw):
            bounds = raw

    result = op.minimize(
        objective, gp.get_parameter_vector(), jac=True, method=method,
        bounds=bounds, **kwargs
    )
    gp.set_parameter_vector(result.x)
    return result


def fit_adam(log_prob_fn, theta0, num_steps=500, learning_rate=0.05,
             b1=0.9, b2=0.999, eps=1e-8, device="cuda"):
    """Adam ascent on ``log_prob_fn``. ``theta0`` is one vector ``(dim,)``
    or a batch of starts ``(k, dim)``, evaluated together by
    ``torch.func.vmap``; a tensor stays on its device, an array goes to
    ``device``. Returns ``(theta_opt, logp_trace)``, the trace of shape
    ``(num_steps,)`` or ``(num_steps, k)``."""
    if not isinstance(theta0, torch.Tensor):
        theta0 = torch.as_tensor(np.asarray(theta0), device=device)
    vag = torch.func.grad_and_value(log_prob_fn)
    if theta0.ndim == 2:
        vag = torch.func.vmap(vag)
    theta = theta0
    m = torch.zeros_like(theta0)
    v = torch.zeros_like(theta0)
    trace = []
    with torch.no_grad():
        for i in range(int(num_steps)):
            g, ll = vag(theta)
            g = torch.where(torch.isfinite(g), g, 0.0)
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * g * g
            mh = m / (1 - b1 ** (i + 1.0))
            vh = v / (1 - b2 ** (i + 1.0))
            theta = theta + learning_rate * mh / (torch.sqrt(vh) + eps)
            trace.append(ll)
    return theta, torch.stack(trace, dim=-1)
