"""A refit as data arrive, as a Bayesian-optimisation loop runs it (george's
``docs/tutorials/bayesopt.rst``): each call factors all the points so far,
``gp.compute(x, yerr)``, then refits for a fixed length, evaluating
``torch.func.grad_and_value(gp.log_prob_fn(x, y, yerr))`` at ``evals``
parameters drawn around the configuration's own, in order, each value and
gradient read to the host before the next starts. The call's function is
dropped when it returns, and ``GP.compute`` drops the previous solver, so
no call keeps another's factors or graph.

A loop that refits for hours has to hold its device memory from call to
call: after every call on a card the bytes allocated may pass those after
the run's first call (the warm-up) by ``GROWTH_SLACK`` at most, or the run
stops with :class:`DeviceMemoryGrowth`. That is no failed operation, which
the harness would count and go on: a program that keeps a buffer a call
cannot run this deployment.

Input ``j`` of a draw is whole: the base data and ``j + 1`` batches of
``growth.batch`` points drawn from the draw's generator by the dataset
recipe's own law (so, for ``sorted_sine_1d``, uniform over the domain),
sorted together, and its ``evals`` parameters. Inputs run in any order. A
draw that would pass ``growth.max_n`` points raises.

Mix parameters: ``evals`` (evaluations a call), ``theta_sd`` (their
spread, in the log parameters, around the configuration's vector)."""

import numpy as np
import torch

from gpbench import harness
from gpbench.entries.value_and_grad import finite, gaps  # noqa: F401

# the bytes a call may add to the device memory held after the first: half
# a cuBLAS workspace (64 MiB), which a program that keeps one a call adds,
# where the allocator's rounding of the blocks it reuses moves the reading
# by about 1 MB from call to call and the n-sized tensors grow by a batch
GROWTH_SLACK = 32 << 20


class DeviceMemoryGrowth(Exception):
    """The device memory held after a call grew past the first call's."""


def _allocated(device):
    """The bytes allocated on ``device``, or None off a card."""
    if device.type != "cuda":
        return None
    return torch.cuda.memory_allocated(device)


def draw(rng, cell, count):
    ds, growth = cell.config["dataset"], cell.config["growth"]
    base, batch = cell.data, growth["batch"]
    if len(base.x) + count * batch > growth["max_n"]:
        raise ValueError(
            "%d inputs of %d new points each take n from %d to %d, past "
            "growth.max_n = %d" % (count, batch, len(base.x),
                                   len(base.x) + count * batch,
                                   growth["max_n"]))
    make = harness._module(cell.root, "datasets", ds["recipe"]).make
    params = dict(ds["params"], n=batch)
    shape = (cell.traffic["evals"], len(cell.theta0))
    parts = [(base.x, base.y, base.yerr)]
    out = []
    for _ in range(count):
        parts.append(make(rng, **params)[:3])
        x, y, yerr = (np.concatenate(p) for p in zip(*parts))
        order = np.argsort(x, kind="stable")
        theta = cell.theta0 + cell.traffic["theta_sd"] * \
            rng.standard_normal(shape)
        out.append({"x": x[order], "y": y[order], "yerr": yerr[order],
                    "theta": theta})
    return out


def make_call(gp, cell):
    dtype, device = gp.dtype, torch.device(gp.device)
    first = []

    def call(inp):
        gp.compute(inp["x"], inp["yerr"])
        f = torch.func.grad_and_value(
            gp.log_prob_fn(inp["x"], inp["y"], inp["yerr"]))
        values, grads = [], []
        for theta in inp["theta"]:
            g, v = f(torch.as_tensor(theta, dtype=dtype, device=device))
            values.append(v.cpu().numpy())
            grads.append(g.cpu().numpy())
        held = _allocated(device)
        if held is not None and not first:
            first.append(held)
        elif held is not None and held > first[0] + GROWTH_SLACK:
            raise DeviceMemoryGrowth(
                "the device memory held after a call grew from %d to %d "
                "bytes" % (first[0], held))
        return (np.array(values, dtype=np.float64),
                np.array(grads, dtype=np.float64))

    return call


def reference(ref, cell, inputs):
    """The exact answers at each input, from a ``BandedGP`` on that input's
    points with ``ref``'s device, precision and least block."""
    from gpbench.reference.gp import BandedGP

    if cell.config["reference"]["method"] != "exact":
        raise ValueError("the recompute entry compares with the exact "
                         "reference only")
    out = []
    for inp in inputs:
        gp = BandedGP(cell.node, inp["x"],
                      inp["yerr"] ** 2 + cell.config["white_noise"],
                      ref.device, precision=ref.prec.name,
                      min_block=ref.min_block)
        values, grads = [], []
        for th in inp["theta"]:
            v, g = gp.loglike_and_grad(cell.full_theta(th), inp["y"])
            values.append(v)
            grads.append(g[cell.active])
        out.append((np.array(values), np.array(grads)))
    return out
