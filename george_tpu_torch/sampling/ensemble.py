# -*- coding: utf-8 -*-
"""Affine-invariant ensemble MCMC (Goodman & Weare stretch moves; PyTorch
port of ``george_tpu/sampling/ensemble.py``).

The documented george inference pattern is ``emcee.EnsembleSampler``
driven by ``gp.lnlikelihood``, which refactorizes once per walker on the
host. Here every walker's likelihood of a half-ensemble update is one
batched call (``torch.func.vmap`` of the log-probability with
``vectorize=True``), so a sweep costs two batched evaluations whatever the
walker count. The red/black sweeps are a host loop; each sweep draws from
its own generator, seeded before the first sweep (``_random.py``).

:class:`EnsembleSampler` is a light stateful wrapper mirroring emcee's
sampler API.
"""

import numpy as np
import torch

from . import _random
from ._chains import LocalChains

__all__ = ["stretch_move_half", "ensemble_step", "run_ensemble",
           "EnsembleSampler"]


def stretch_move_half(gen, active, active_logp, other, log_prob_fn, a=2.0,
                      chains=None):
    """One stretch-move update of ``active`` walkers ``(k, ndim)`` against
    the complementary ensemble ``other`` ``(m, ndim)``, drawing from the
    ``torch.Generator`` ``gen``; ``log_prob_fn`` is batched (``(k, ndim)
    -> (k,)``). Returns the updated ``(walkers, logp, accepted)``.

    Under a sharded reducer ``chains`` both halves are this shard's rows:
    the draws are made for the whole half and each shard keeps its rows,
    and the partners come from the other half of every shard."""
    chains = chains or LocalChains()
    k, ndim = active.shape
    k_all = chains.total(k)
    other = chains.gather(other)
    like = {"dtype": active.dtype, "device": active.device}
    # z ~ g(z) \propto 1/sqrt(z) on [1/a, a]
    u = chains.rows(torch.rand(k_all, generator=gen, **like))
    z = ((a - 1.0) * u + 1.0) ** 2 / a
    idx = chains.rows(torch.randint(0, other.shape[0], (k_all,),
                                    generator=gen, device=active.device))
    partners = other[idx]
    proposal = partners + z[:, None] * (active - partners)
    new_logp = log_prob_fn(proposal)
    log_ratio = (ndim - 1.0) * torch.log(z) + new_logp - active_logp
    accept = torch.log(chains.rows(
        torch.rand(k_all, generator=gen, **like))) < log_ratio
    walkers = torch.where(accept[:, None], proposal, active)
    logp = torch.where(accept, new_logp, active_logp)
    return walkers, logp, accept


def _step_halves(gen, halves, logps, log_prob_fn, a=2.0, chains=None):
    """Red/black sweep on the two halves of the ensemble."""
    chains = chains or LocalChains()
    (first, second), (lp1, lp2) = halves, logps
    first, lp1, acc1 = stretch_move_half(gen, first, lp1, second,
                                         log_prob_fn, a, chains)
    second, lp2, acc2 = stretch_move_half(gen, second, lp2, first,
                                          log_prob_fn, a, chains)
    acc = 0.5 * (chains.mean(acc1.to(lp1.dtype))
                 + chains.mean(acc2.to(lp2.dtype)))
    return (first, second), (lp1, lp2), acc


def ensemble_step(key, walkers, logp, log_prob_fn, a=2.0):
    """One full red/black ensemble sweep. ``walkers``: ``(nw, ndim)``;
    ``key``: a ``torch.Generator`` on the walkers' device or an int seed.
    Returns ``(walkers, logp, accept_fraction)``."""
    gen = key if isinstance(key, torch.Generator) else \
        _random.step_generator(key, walkers.device)
    half = walkers.shape[0] // 2
    with torch.no_grad():
        (first, second), (lp1, lp2), acc = _step_halves(
            gen, (walkers[:half], walkers[half:]),
            (logp[:half], logp[half:]), log_prob_fn, a)
    return torch.cat([first, second]), torch.cat([lp1, lp2]), acc


def run_ensemble(key, p0, log_prob_fn, nsteps, thin=1, a=2.0, chains=None):
    """Run ``nsteps`` ensemble sweeps from ``p0`` ``(nw, ndim)`` (a tensor,
    on its device). ``key``: a ``torch.Generator`` or an int seed.

    Returns ``(chain, logps, accept)`` with ``chain`` of shape ``(nsteps //
    thin, nw, ndim)``: every ``thin``-th state, its log-probabilities and
    the acceptance fraction of its sweep.

    ``chains`` is the cross-walker reducer (default :class:`LocalChains`);
    under the sharded one of ``parallel``, ``p0`` is this shard's rows of
    the first half followed by its rows of the second half, and so are
    the outputs.
    """
    nkept = int(nsteps) // int(thin)
    seeds = _random.step_seeds(key, nkept * int(thin))
    half = p0.shape[0] // 2
    chain, logps, accs = [], [], []
    with torch.no_grad():
        logp0 = log_prob_fn(p0)
        halves = (p0[:half], p0[half:])
        lps = (logp0[:half], logp0[half:])
        for s, seed in enumerate(seeds):
            gen = _random.step_generator(seed, p0.device)
            halves, lps, acc = _step_halves(gen, halves, lps, log_prob_fn, a,
                                            chains)
            if (s + 1) % thin == 0:
                chain.append(torch.cat(halves))
                logps.append(torch.cat(lps))
                accs.append(acc)
    if not chain:
        return (p0.new_zeros((0,) + tuple(p0.shape)),
                p0.new_zeros((0, p0.shape[0])), p0.new_zeros(0))
    return torch.stack(chain), torch.stack(logps), torch.stack(accs)


class EnsembleSampler(object):
    """emcee-style wrapper over the batched ensemble update.

    :param nwalkers: number of walkers (even).
    :param ndim: parameter dimension.
    :param log_prob_fn: scalar log-probability ``f(theta)`` in torch ops;
        with ``vectorize=True`` it is ``torch.func.vmap``-ed over walkers,
        otherwise it must take ``(k, ndim)`` and return ``(k,)`` itself.
    :param a: stretch scale (emcee default 2.0).
    :param device: where walkers given as arrays are placed (default
        ``"cuda"``); walkers given as a tensor stay on its device.
    """

    def __init__(self, nwalkers, ndim, log_prob_fn, a=2.0, vectorize=True,
                 device="cuda"):
        if nwalkers % 2:
            raise ValueError("nwalkers must be even")
        self.nwalkers = int(nwalkers)
        self.ndim = int(ndim)
        self.a = float(a)
        self.device = torch.device(device)
        self._batched = (torch.func.vmap(log_prob_fn) if vectorize
                         else log_prob_fn)
        self._chain = None
        self._logps = None
        self._accs = None

    def run_mcmc(self, p0, nsteps, seed=0, thin=1):
        """Run the sampler; returns ``(final_walkers, final_logp)``."""
        if not isinstance(p0, torch.Tensor):
            p0 = torch.as_tensor(np.atleast_2d(p0), dtype=torch.float64,
                                 device=self.device)
        if tuple(p0.shape) != (self.nwalkers, self.ndim):
            raise ValueError("p0 must have shape (nwalkers, ndim)")
        chain, logps, accs = run_ensemble(
            seed, p0, self._batched, int(nsteps), thin=int(thin), a=self.a)
        self._chain = chain.cpu().numpy()
        self._logps = logps.cpu().numpy()
        self._accs = accs.cpu().numpy()
        return self._chain[-1], self._logps[-1]

    @property
    def chain(self):
        """Samples, shape ``(nwalkers, nsteps, ndim)`` (emcee layout)."""
        return np.swapaxes(self._chain, 0, 1)

    @property
    def flatchain(self):
        return self._chain.reshape(-1, self.ndim)

    @property
    def lnprobability(self):
        return np.swapaxes(self._logps, 0, 1)

    @property
    def acceptance_fraction(self):
        return np.broadcast_to(self._accs.mean(), (self.nwalkers,))
