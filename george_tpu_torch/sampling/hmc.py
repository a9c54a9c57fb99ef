# -*- coding: utf-8 -*-
"""Gradient-based samplers: HMC and iterative NUTS with window adaptation
(PyTorch port of ``george_tpu/sampling/hmc.py``).

* Chains are the leading dimension of every state tensor. The value and
  gradient of all chains come from one call of
  ``torch.func.vmap(torch.func.grad_and_value(log_prob_fn))``, as JAX's
  ``vmap`` of ``value_and_grad``: with the HODLR likelihood that is one
  leaf-Cholesky launch for all chains per leapfrog step.
* Step size is adapted by Nesterov dual averaging per chain, and the mass
  matrix (diagonal or dense) by pooled cross-chain Welford statistics over
  Stan's slow windows.
* NUTS is the iterative multinomial formulation with the checkpoint bit
  trick for the sub-tree U-turn checks. The JAX sampler is one
  ``lax.scan`` whose tree is a ``while_loop`` under ``vmap``; here the
  steps, doublings and leaves are a host loop over all chains at once. A
  chain that has finished its tree is masked but still evaluated (what
  ``vmap`` of ``while_loop`` does), and the loop reads the device at most
  once per leapfrog step, to end the tree when no chain is left in it. The
  returned ``stats`` count the leapfrog steps and the reads.

Checkpoint scheme: leaves are numbered 0..2^d-1 within a subtree. A state
is stored when its leaf index ``j`` is even, at slot ``popcount(j)``. At an
odd leaf ``i`` with ``i+1 = M * 2^v`` (M odd), the subtrees ending at ``i``
have left-boundary leaves at slots ``popcount(M-1) .. popcount(M-1)+v-1``,
a contiguous range — so all sub-tree U-turn checks are O(max_depth)
lookups. Every chain of a tree sits at the same leaf, so the slots are
host integers.

Random stream: see ``_random.py``; the sampler fixes every step's seed
before the first step, so ``segment_size`` never changes the draws.
"""

import math

import numpy as np
import torch

from . import _random
from ._chains import LocalChains

__all__ = ["sample_hmc", "sample_nuts", "HMC", "NUTS", "WarmupSchedule"]

_ENERGY = torch.float64


def _chains(mask, a, b):
    """``where(mask, a, b)`` with a ``(C,)`` mask over ``(C, ...)``."""
    return torch.where(mask.reshape(mask.shape + (1,) * (a.ndim - 1)), a, b)


# ---------------------------------------------------------------------------
# Leapfrog
# ---------------------------------------------------------------------------

def _mass_matvec(inv_mass, p):
    """``M^{-1} p`` for ``p`` ``(..., dim)``. ``inv_mass`` is a ``(dim,)``
    diagonal or, for dense mass adaptation, a dict ``{"sigma": (dim, dim),
    "chol": (dim, dim)}`` with ``sigma`` the inverse mass (the pooled
    posterior-covariance estimate) and ``chol`` its lower Cholesky
    factor."""
    if isinstance(inv_mass, dict):
        return p @ inv_mass["sigma"].mT
    return inv_mass * p


def _draw_momentum(z, inv_mass):
    """``p ~ N(0, M)`` (``M`` the inverse of ``inv_mass``) from standard
    normal draws ``z`` ``(..., dim)``. Dense: ``sigma = L L^T``, so
    ``p = L^{-T} z`` has covariance ``sigma^{-1}``."""
    if isinstance(inv_mass, dict):
        return torch.linalg.solve_triangular(
            inv_mass["chol"].mT, z[..., None], upper=True)[..., 0]
    return z / torch.sqrt(inv_mass)


def _leapfrog(value_and_grad, q, p, grad, eps, inv_mass):
    """One leapfrog step. Returns ``(q, p, logp, grad)``."""
    p_half = p + 0.5 * eps * grad
    q_new = q + eps * _mass_matvec(inv_mass, p_half)
    logp_new, grad_new = value_and_grad(q_new)
    p_new = p_half + 0.5 * eps * grad_new
    return q_new, p_new, logp_new, grad_new


def _kinetic_hi(p, inv_mass):
    """Kinetic energy of ``p`` ``(..., dim)``, always summed in float64:
    in float32 chains the energies are O(|logp|) while the acceptance and
    divergence logic consumes O(1) differences, and the float32
    cancellation noise would trip the divergence check spuriously."""
    p = p.to(_ENERGY)
    if isinstance(inv_mass, dict):
        return 0.5 * torch.sum(p * (p @ inv_mass["sigma"].to(_ENERGY).mT),
                               dim=-1)
    return 0.5 * torch.sum(p * p * inv_mass.to(_ENERGY), dim=-1)


# ---------------------------------------------------------------------------
# Transitions (all chains at once)
# ---------------------------------------------------------------------------

def hmc_transition(draws, q, logp, grad, value_and_grad, eps, inv_mass,
                   num_steps, counts):
    """HMC transition of every chain with ``num_steps`` leapfrog steps.
    ``draws`` is ``(z (C, dim) standard normal, u (C,) uniform)``; ``eps``
    the per-chain step sizes ``(C,)``."""
    z, u = draws
    p0 = _draw_momentum(z, inv_mass)
    energy0 = -logp.to(_ENERGY) + _kinetic_hi(p0, inv_mass)
    qn, pn, lpn, gn = q, p0, logp, grad
    for _ in range(num_steps):
        qn, pn, lpn, gn = _leapfrog(value_and_grad, qn, pn, gn, eps[:, None],
                                    inv_mass)
        counts["leapfrog_evals"] += 1
    energy1 = -lpn.to(_ENERGY) + _kinetic_hi(pn, inv_mass)
    log_accept = torch.clamp(energy0 - energy1, max=0.0).to(q.dtype)
    log_accept = torch.where(torch.isfinite(log_accept), log_accept,
                             -math.inf)
    accept = torch.log(u) < log_accept
    return (_chains(accept, qn, q), torch.where(accept, lpn, logp),
            _chains(accept, gn, grad), torch.exp(log_accept))


def _popcount(x):
    """Set bits of each 32-bit ``x`` (an int or an integer tensor)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def _trailing_ones(x):
    # number of trailing 1-bits of x = trailing zeros of x+1
    return _popcount((~x & (x + 1)) - 1)


def _uturn(q_left, q_right, p_left, p_right, inv_mass):
    """Generalized U-turn criterion on trajectory-time-ordered endpoints
    (``(..., dim)``): ``q_left``/``p_left`` must be the earlier point *in
    trajectory time* (a backward integration visits points in reverse
    trajectory time)."""
    dq = q_right - q_left
    return ((torch.sum(dq * _mass_matvec(inv_mass, p_left), dim=-1) < 0)
            | (torch.sum(dq * _mass_matvec(inv_mass, p_right), dim=-1) < 0))


_ENDS = ("q", "p", "g", "lp")


def nuts_transition(draws, q, logp, grad, value_and_grad, eps, inv_mass,
                    max_depth, counts, divergence_threshold=1000.0,
                    chains=None):
    """Multinomial NUTS transition of every chain (iterative, bounded
    loops).

    ``draws`` is ``(z (C, dim) standard normal, U (C, 2 max_depth +
    2^max_depth) uniform)``: per doubling a direction and a biased-take
    uniform, per leaf a multinomial-take uniform. ``eps``: ``(C,)``.
    Returns ``(q, logp, grad, accept_prob_proxy, depth, diverged)``.
    ``chains`` (default :class:`LocalChains`) answers the loops' "is any
    chain still going" across every shard of a sharded run, so that all
    shards evaluate the same number of leapfrog steps.
    """
    chains = chains or LocalChains()
    z, U = draws
    dtype = q.dtype
    C, dim = q.shape
    eps = eps[:, None]
    p0 = _draw_momentum(z, inv_mass)
    energy0 = -logp.to(_ENERGY) + _kinetic_hi(p0, inv_mass)
    false = torch.zeros(C, dtype=torch.bool, device=q.device)
    zero = torch.zeros(C, dtype=dtype, device=q.device)
    # the trajectory: "_l" the backward end, "_r" the forward end
    start = {"q": q, "p": p0, "g": grad, "lp": logp}
    traj = {k + s: v for k, v in start.items() for s in ("_l", "_r")}
    traj.update({"q_prop": q, "lp_prop": logp, "g_prop": grad,
                 "log_w": zero, "depth": torch.zeros(C, dtype=torch.int64,
                                                      device=q.device),
                 "turning": false, "diverging": false, "sum_acc": zero,
                 "n_leap": zero})
    active = ~false          # chains whose doubling loop goes on
    leaf = 2 * max_depth     # column of U for the next leaf
    for depth in range(max_depth):
        go_right = U[:, 2 * depth] < 0.5
        u_bias = U[:, 2 * depth + 1]
        direction = torch.where(go_right, 1.0, -1.0).to(dtype)[:, None]
        st = {k: _chains(go_right, traj[k + "_r"], traj[k + "_l"])
              for k in _ENDS}
        st.update({"q_prop": st["q"], "lp_prop": st["lp"],
                   "g_prop": st["g"],
                   "log_w": torch.full((C,), -math.inf, dtype=dtype,
                                       device=q.device),
                   "turning": false, "diverging": false, "sum_acc": zero,
                   "n_exec": zero})
        ckpt_q = q.new_zeros((C, max_depth + 1, dim))
        ckpt_p = q.new_zeros((C, max_depth + 1, dim))
        live = active
        n_leaf = 1 << depth
        ended = False
        for i in range(n_leaf):
            qq, pp, lpq, gg = _leapfrog(value_and_grad, st["q"], st["p"],
                                        st["g"], direction * eps, inv_mass)
            counts["leapfrog_evals"] += 1
            energy = -lpq.to(_ENERGY) + _kinetic_hi(pp, inv_mass)
            d_energy = (energy - energy0).to(dtype)
            d_energy = torch.where(torch.isfinite(d_energy), d_energy,
                                   math.inf)
            log_w_leaf = -d_energy
            # accept-prob proxy for dual averaging (Stan's statistic)
            acc = torch.exp(torch.clamp(log_w_leaf, max=0.0))
            # progressive multinomial sampling within the subtree
            log_w_new = torch.logaddexp(st["log_w"], log_w_leaf)
            take = torch.log(U[:, leaf]) < log_w_leaf - log_w_new
            leaf += 1
            turning = st["turning"]
            if i % 2 == 0:
                # checkpoint store (even leaf)
                slot = _popcount(i)
                ckpt_q[:, slot] = _chains(live, qq, ckpt_q[:, slot])
                ckpt_p[:, slot] = _chains(live, pp, ckpt_p[:, slot])
            else:
                # sub-tree U-turn checks (odd leaf): slots lo..lo+v-1. The
                # checkpoint precedes the leaf in integration order; in
                # trajectory time the pair is reversed when integrating
                # backward, so the displacement is oriented by direction
                v = _trailing_ones(i)
                lo = _popcount(((i + 1) >> v) - 1)
                cq, cp = ckpt_q[:, lo:lo + v], ckpt_p[:, lo:lo + v]
                dq = direction[:, None] * (qq[:, None] - cq)
                t = ((torch.sum(dq * _mass_matvec(inv_mass, cp), -1) < 0)
                     | (torch.sum(dq * _mass_matvec(inv_mass, pp)[:, None],
                                  -1) < 0))
                turning = turning | torch.any(t, dim=1)
            new = {"q": qq, "p": pp, "g": gg, "lp": lpq,
                   "q_prop": _chains(take, qq, st["q_prop"]),
                   "lp_prop": torch.where(take, lpq, st["lp_prop"]),
                   "g_prop": _chains(take, gg, st["g_prop"]),
                   "log_w": log_w_new, "turning": turning,
                   "diverging": st["diverging"] | (
                       d_energy > divergence_threshold),
                   "sum_acc": st["sum_acc"] + acc,
                   "n_exec": st["n_exec"] + 1.0}
            st = {k: _chains(live, new[k], st[k]) for k in st}
            live = live & ~(st["turning"] | st["diverging"])
            if i < n_leaf - 1:
                counts["host_reads"] += 1
                if not chains.any(live):
                    ended = True
                    break

        # biased progressive sampling between old trajectory and subtree
        ok = ~(st["turning"] | st["diverging"])
        take = ok & (torch.log(u_bias) < st["log_w"] - traj["log_w"])
        new = {"q_prop": _chains(take, st["q_prop"], traj["q_prop"]),
               "lp_prop": torch.where(take, st["lp_prop"], traj["lp_prop"]),
               "g_prop": _chains(take, st["g_prop"], traj["g_prop"])}
        # extend the trajectory end we grew
        for k in _ENDS:
            new[k + "_l"] = _chains(go_right, traj[k + "_l"], st[k])
            new[k + "_r"] = _chains(go_right, st[k], traj[k + "_r"])
        turning_full = _uturn(new["q_l"], new["q_r"], new["p_l"],
                              new["p_r"], inv_mass)
        new.update({
            "log_w": torch.logaddexp(traj["log_w"], st["log_w"]),
            "depth": traj["depth"] + 1,
            "turning": st["turning"] | (ok & turning_full),
            "diverging": st["diverging"],
            "sum_acc": traj["sum_acc"] + st["sum_acc"],
            "n_leap": traj["n_leap"] + st["n_exec"]})
        traj = {k: _chains(active, new[k], traj[k]) for k in traj}
        active = active & ~(traj["turning"] | traj["diverging"])
        if ended or depth + 1 == max_depth:
            break
        counts["host_reads"] += 1
        if not chains.any(active):
            break
    accept_stat = traj["sum_acc"] / torch.clamp(traj["n_leap"], min=1.0)
    return (traj["q_prop"], traj["lp_prop"], traj["g_prop"], accept_stat,
            traj["depth"], traj["diverging"])


# ---------------------------------------------------------------------------
# Warmup adaptation (Stan-style windows, cross-chain statistics)
# ---------------------------------------------------------------------------

class WarmupSchedule(object):
    """Stan's three-phase warmup: fast start (step size only), expanding
    slow windows (mass matrix), fast tail, as host-side flag arrays."""

    def __init__(self, num_warmup, init_buffer=75, term_buffer=50,
                 base_window=25):
        num_warmup = int(num_warmup)
        if num_warmup < init_buffer + term_buffer + base_window:
            init_buffer = max(1, int(0.15 * num_warmup))
            term_buffer = max(1, int(0.1 * num_warmup))
            base_window = max(1, num_warmup - init_buffer - term_buffer)
        self.num_warmup = num_warmup
        in_slow = np.zeros(num_warmup, dtype=bool)
        window_end = np.zeros(num_warmup, dtype=bool)
        t = init_buffer
        w = base_window
        while t < num_warmup - term_buffer:
            end = min(t + w, num_warmup - term_buffer)
            # final window absorbs the remainder
            if end + 2 * w > num_warmup - term_buffer:
                end = num_warmup - term_buffer
            in_slow[t:end] = True
            window_end[end - 1] = True
            t = end
            w *= 2
        self.in_slow = in_slow
        self.window_end = window_end


def _robust_final_eps(log_eps_avg, clip, chains=None):
    """Cross-chain robustified post-warmup step sizes: each chain's
    averaged estimate is capped at ``clip`` times the cross-chain median
    of the finite estimates and floored at ``median / clip**2``; a
    non-finite estimate restarts at the median. (A chain whose last
    adaptation window sat in a flat region can leave warmup with a step
    size an order of magnitude above its siblings' and then diverge on a
    third of its transitions in the stiff part of a GP posterior; the
    median, not the mean, anchors the clip, since a mean is pulled up by
    the very chains being clipped.) The median is over the chains of
    every shard (``chains``, default :class:`LocalChains`)."""
    chains = chains or LocalChains()
    local = log_eps_avg
    log_eps_avg = chains.gather(local)
    finite = torch.isfinite(log_eps_avg)
    n_finite = torch.sum(finite.to(torch.int64))
    le_sorted = torch.sort(torch.where(finite, log_eps_avg, math.inf)).values
    med = le_sorted[torch.clamp(n_finite - 1, min=0) // 2]
    log_clip = math.log(float(clip))
    capped = torch.clamp(local, min=med - 2.0 * log_clip,
                         max=med + log_clip)
    return torch.exp(torch.where(torch.isfinite(local), capped, med))


def _dual_averaging_init(eps0, dtype, nchains=None, device=None):
    """Dual-averaging state, PER CHAIN: each chain adapts its own step
    size against its own acceptance statistic (a single pooled step size
    fails when chains sit in regions of different curvature)."""
    eps0 = torch.as_tensor(eps0, dtype=dtype, device=device)
    if nchains is not None and eps0.ndim == 0:
        eps0 = eps0 * torch.ones(nchains, dtype=dtype, device=eps0.device)
    zeros = torch.zeros_like(eps0)
    return {"log_eps": torch.log(eps0), "log_eps_avg": zeros,
            "h_sum": zeros, "mu": torch.log(10.0 * eps0), "count": zeros}


def _dual_averaging_update(da, accept_mean, target, gamma=0.05, t0=10.0,
                           kappa=0.75):
    count = da["count"] + 1.0
    h_sum = da["h_sum"] + (target - accept_mean)
    log_eps = da["mu"] - (torch.sqrt(count) / gamma) * h_sum / (count + t0)
    w = count ** (-kappa)
    log_eps_avg = w * log_eps + (1.0 - w) * da["log_eps_avg"]
    return {"log_eps": log_eps, "log_eps_avg": log_eps_avg, "h_sum": h_sum,
            "mu": da["mu"], "count": count}


# ---------------------------------------------------------------------------
# Samplers
# ---------------------------------------------------------------------------

def _make_value_and_grad(log_prob_fn, chain_batch=None):
    """All chains' ``(logp (C,), grad (C, dim))`` in one batched call (in
    calls of at most ``chain_batch`` chains, when given); non-finite values
    map to ``-inf`` and non-finite gradient entries to 0."""
    gv = torch.func.vmap(torch.func.grad_and_value(log_prob_fn))

    def value_and_grad(q):
        if chain_batch is None or q.shape[0] <= chain_batch:
            g, v = gv(q)
        else:
            parts = [gv(q[i:i + chain_batch])
                     for i in range(0, q.shape[0], chain_batch)]
            g = torch.cat([p[0] for p in parts])
            v = torch.cat([p[1] for p in parts])
        v = torch.where(torch.isfinite(v), v, -math.inf)
        g = torch.where(torch.isfinite(g), g, 0.0)
        return v, g

    return value_and_grad


def _make_transition(value_and_grad, algorithm, num_leapfrog, max_depth,
                     counts, chains):
    """``transition(seed, q, lp, g, eps, inv_mass) -> (q, lp, g, acc,
    extras)``, drawing the step's randomness from its seed. The draws are
    made for the chains of every shard and each shard keeps its rows, so a
    chain draws the same numbers however the chains are sharded."""
    def draws(seed, q):
        gen = _random.step_generator(seed, q.device)
        C, dim = chains.total(q.shape[0]), q.shape[1]
        z = torch.randn((C, dim), generator=gen, dtype=q.dtype,
                        device=q.device)
        width = 2 * max_depth + (1 << max_depth) if algorithm == "nuts" \
            else 1
        u = torch.rand((C, width), generator=gen, dtype=q.dtype,
                       device=q.device)
        return chains.rows(z), chains.rows(u)

    if algorithm == "nuts":
        def transition(seed, q, lp, g, eps, inv_mass):
            eps = eps * torch.ones(q.shape[0], dtype=q.dtype,
                                   device=q.device)
            q, lp, g, acc, depth, div = nuts_transition(
                draws(seed, q), q, lp, g, value_and_grad, eps, inv_mass,
                max_depth, counts, chains=chains)
            return q, lp, g, acc, {"depth": depth, "diverging": div}
    else:
        def transition(seed, q, lp, g, eps, inv_mass):
            eps = eps * torch.ones(q.shape[0], dtype=q.dtype,
                                   device=q.device)
            z, u = draws(seed, q)
            q, lp, g, acc = hmc_transition(
                (z, u[:, 0]), q, lp, g, value_and_grad, eps, inv_mass,
                num_leapfrog, counts)
            return q, lp, g, acc, {}
    return transition


def _warmup_chunk(seeds, carry, in_slow, window_end, transition,
                  target_accept, chains):
    """A run of warmup iterations; the adaptation state threads through
    ``carry`` so warmup can be split into arbitrary segments. The pooled
    statistics reduce over the chains of every shard (``chains``)."""
    q, lp, g, da, inv_mass, welford = carry
    dense = isinstance(inv_mass, dict)
    accs = []
    for seed, slow, wend in zip(seeds, in_slow, window_end):
        eps = torch.exp(da["log_eps"])
        q, lp, g, acc, _ = transition(seed, q, lp, g, eps, inv_mass)
        # per-chain acceptance -> per-chain step size
        da = _dual_averaging_update(da, acc, target_accept)
        accs.append(acc)

        if slow:
            # pooled cross-chain Welford, the within-batch spread too
            cnt, mean, m2 = welford
            batch_mean = chains.mean(q)
            delta = batch_mean - mean
            cnt = cnt + 1.0
            mean_new = mean + delta / cnt
            dev = q - batch_mean[None, :]
            if dense:
                m2 = (m2 + chains.sum(dev.mT @ dev)
                      / chains.total(q.shape[0])
                      + torch.outer(delta, batch_mean - mean_new))
            else:
                m2 = (m2 + chains.mean(dev ** 2)
                      + delta * (batch_mean - mean_new))
            welford = (cnt, mean_new, m2)

        if wend:
            # window end: refresh the mass matrix, restart step-size
            # averaging and the Welford sums
            cnt, mean, m2 = welford
            if dense:
                # Stan's shrinkage toward a small identity keeps the
                # estimate well-conditioned when few draws have accumulated
                w = cnt / (cnt + 5.0)
                sigma = w * (m2 / max(cnt - 1.0, 1.0)) + (
                    1e-3 * (1.0 - w) + 1e-5) * torch.eye(
                        q.shape[1], dtype=q.dtype, device=q.device)
                inv_mass = {"sigma": sigma,
                            "chol": torch.linalg.cholesky(sigma)}
            else:
                inv_mass = m2 / max(cnt - 1.0, 1.0) + 1e-5
            da = _dual_averaging_init(torch.exp(da["log_eps"]), q.dtype)
            welford = (0.0, torch.zeros_like(mean), torch.zeros_like(m2))
    return (q, lp, g, da, inv_mass, welford), accs


def _sample_chunk(seeds, q, lp, g, eps, inv_mass, transition):
    """A run of posterior draws with fixed tuning."""
    out = []
    for seed in seeds:
        q, lp, g, acc, extras = transition(seed, q, lp, g, eps, inv_mass)
        step = {"q": q, "logp": lp, "accept": acc}
        step.update(extras)
        out.append(step)
    return (q, lp, g), out


def _segments(total, size):
    if not total:
        return []
    if size is None or size >= total:
        return [(0, total)]
    out = []
    start = 0
    while start < total:
        out.append((start, min(start + size, total)))
        start += size
    return out


def _as_chains(p0, device):
    """``p0`` as a ``(chains, dim)`` tensor: a tensor stays on its device,
    anything else goes to ``device``."""
    if isinstance(p0, torch.Tensor):
        return p0 if p0.ndim == 2 else p0[None, :]
    return torch.as_tensor(np.atleast_2d(np.asarray(p0)), device=device)


def _sample(key, p0, log_prob_fn, num_warmup, num_samples,
            algorithm="nuts", num_leapfrog=32, max_depth=10,
            target_accept=0.8, segment_size=None, step_size_clip=2.0,
            dense_mass=False, chains=None, _chain_batch=None):
    """Warmup + sampling loop. ``p0``: ``(chains, dim)`` tensor.

    A finite ``segment_size`` splits warmup and sampling into runs of at
    most that many steps with the adaptation state threaded between them
    (for periodic checkpointing of long runs); the draws do not change.

    ``chains`` is the cross-chain reducer (default :class:`LocalChains`);
    ``parallel`` passes the one of a chain-sharded run, where ``p0`` holds
    this shard's chains and every output is this shard's.

    ``_chain_batch`` is for tests only: it evaluates the chains in calls
    of at most that many. A chain's values round as the batch it is
    evaluated in does (the libraries' reductions and batched
    factorizations pick their schedule by batch size), and the warmup's
    adaptation amplifies such 1-ulp differences into different draws, so a
    chain-sharded run equals, to rounding, only the unsharded run with
    ``_chain_batch`` equal to the shard's chain count: the reference that
    the sharded samplers are held to. The public samplers never set it.
    """
    chains = chains or LocalChains()
    nchains, dim = p0.shape
    dtype, device = p0.dtype, p0.device
    counts = {"leapfrog_evals": 0, "host_reads": 0}
    with torch.no_grad():
        value_and_grad = _make_value_and_grad(log_prob_fn, _chain_batch)
        transition = _make_transition(value_and_grad, algorithm,
                                      num_leapfrog, max_depth, counts,
                                      chains)
        lp0, g0 = value_and_grad(p0)

        sched = WarmupSchedule(num_warmup)
        if dense_mass:
            # inverse mass = pooled posterior covariance (dim x dim): the
            # tool for the strongly correlated hyperparameter posteriors
            # of GP marginal likelihoods
            eye = torch.eye(dim, dtype=dtype, device=device)
            mass0 = {"sigma": eye, "chol": eye}
            m2_0 = torch.zeros((dim, dim), dtype=dtype, device=device)
        else:
            mass0 = torch.ones(dim, dtype=dtype, device=device)
            m2_0 = torch.zeros(dim, dtype=dtype, device=device)
        carry = (p0, lp0, g0,
                 _dual_averaging_init(0.1, dtype, nchains=nchains,
                                      device=device),
                 mass0,
                 (0.0, torch.zeros(dim, dtype=dtype, device=device), m2_0))

        seeds = _random.step_seeds(key, num_warmup + num_samples)
        warm_accs = []
        for (a, b) in _segments(num_warmup, segment_size):
            carry, acc = _warmup_chunk(
                seeds[a:b], carry, sched.in_slow[a:b],
                sched.window_end[a:b], transition, target_accept, chains)
            warm_accs += acc
        q, lp, g, da, inv_mass, _ = carry
        if step_size_clip is not None and chains.total(nchains) > 1:
            eps_final = _robust_final_eps(da["log_eps_avg"],
                                          float(step_size_clip), chains)
        else:
            eps_final = torch.exp(da["log_eps_avg"])

        steps = []
        for (a, b) in _segments(num_samples, segment_size):
            (q, lp, g), chunk = _sample_chunk(
                seeds[num_warmup + a:num_warmup + b], q, lp, g, eps_final,
                inv_mass, transition)
            steps += chunk

    def stacked(name, empty_shape):
        if not steps:
            return torch.zeros(empty_shape, dtype=dtype, device=device)
        return torch.stack([s[name] for s in steps])

    stats = {
        "step_size": eps_final,
        "inv_mass": inv_mass,
        "warmup_accept": torch.stack(warm_accs) if warm_accs
        else torch.zeros((0, nchains), dtype=dtype, device=device),
        "accept": stacked("accept", (0, nchains)),
        "logp": stacked("logp", (0, nchains)),
        "leapfrog_evals": counts["leapfrog_evals"],
        "host_reads": counts["host_reads"],
    }
    if algorithm == "nuts":
        stats["depth"] = stacked("depth", (0, nchains))
        stats["diverging"] = stacked("diverging", (0, nchains))
    return stacked("q", (0, nchains, dim)), stats


def sample_nuts(key, log_prob_fn, p0, num_warmup=500, num_samples=500,
                max_depth=10, target_accept=0.8, segment_size=None,
                step_size_clip=2.0, dense_mass=False, device="cuda"):
    """NUTS over batched chains. ``key``: a ``torch.Generator`` or an int
    seed. ``p0``: ``(chains, dim)``, a tensor (sampled on its device and in
    its dtype) or an array (sampled on ``device``). ``log_prob_fn`` maps a
    ``(dim,)`` tensor to a scalar tensor and must compose with
    ``torch.func.vmap`` and ``grad`` (``GP.log_prob_fn`` does). Returns
    ``(samples (num_samples, chains, dim), stats)``; ``stats`` holds the
    step sizes, the inverse mass, per-draw acceptance, log-probability,
    tree depth and divergence, and the counts ``leapfrog_evals`` (batched
    evaluations of all chains) and ``host_reads``.

    ``step_size_clip`` bounds each chain's post-warmup step size within
    ``[med/clip^2, med*clip]`` around the cross-chain median (``None``
    disables) — see ``_robust_final_eps``. ``dense_mass`` adapts a full
    ``(dim, dim)`` inverse mass from the pooled cross-chain covariance
    instead of a diagonal: use it for the correlated posteriors of GP
    marginal likelihoods."""
    return _sample(
        key, _as_chains(p0, device), log_prob_fn, int(num_warmup),
        int(num_samples), algorithm="nuts", max_depth=int(max_depth),
        target_accept=float(target_accept), segment_size=segment_size,
        step_size_clip=step_size_clip, dense_mass=bool(dense_mass),
    )


def sample_hmc(key, log_prob_fn, p0, num_warmup=500, num_samples=500,
               num_leapfrog=32, target_accept=0.8, segment_size=None,
               step_size_clip=2.0, dense_mass=False, device="cuda"):
    """Fixed-length HMC over batched chains (arguments as
    :func:`sample_nuts`)."""
    return _sample(
        key, _as_chains(p0, device), log_prob_fn, int(num_warmup),
        int(num_samples), algorithm="hmc", num_leapfrog=int(num_leapfrog),
        target_accept=float(target_accept), segment_size=segment_size,
        step_size_clip=step_size_clip, dense_mass=bool(dense_mass),
    )


class _GradSampler(object):
    algorithm = None

    def __init__(self, log_prob_fn, num_warmup=500, device="cuda",
                 **options):
        self.log_prob_fn = log_prob_fn
        self.num_warmup = int(num_warmup)
        self.device = torch.device(device)
        self.options = options
        self.stats = None

    def run(self, p0, num_samples, seed=0):
        """Sample from ``p0`` ``(chains, dim)`` (on ``device`` unless it is
        a tensor); returns the draws as numpy ``(num_samples, chains,
        dim)`` and keeps the statistics, as numpy, in ``stats``."""
        samples, stats = _sample(
            seed, _as_chains(p0, self.device), self.log_prob_fn,
            self.num_warmup, int(num_samples), algorithm=self.algorithm,
            **self.options)

        def host(v):
            if isinstance(v, dict):
                return {k: host(x) for k, x in v.items()}
            if isinstance(v, torch.Tensor):
                return v.cpu().numpy()
            return v

        self.stats = host(stats)
        return samples.cpu().numpy()


class NUTS(_GradSampler):
    algorithm = "nuts"


class HMC(_GradSampler):
    algorithm = "hmc"
