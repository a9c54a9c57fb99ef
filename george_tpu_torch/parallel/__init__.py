# -*- coding: utf-8 -*-
"""Distribution over ranks: chain-parallel sampling, data-parallel
prediction and the row-sharded solvers' meshes (PyTorch port of
``george_tpu/parallel``).

The JAX package is single-controller: it shards a batch axis over a device
mesh and XLA inserts the collectives. Here the model is SPMD, as
``torch.distributed`` has it: one process per rank runs the same script
(``torchrun``, ``torch.multiprocessing``), every rank passes the same
host arrays, and the code calls the collectives itself.

* :func:`initialize` joins the process group (NCCL when every rank has a
  GPU of its own, gloo otherwise: the CPU, or several ranks sharing one
  card); :func:`chain_mesh` is a one-dimensional ``DeviceMesh`` over it.
* **Chain parallelism**: :func:`sharded_sample_nuts`,
  :func:`sharded_sample_hmc` and :func:`sharded_run_ensemble` run the
  samplers on this rank's chains or walkers. The samplers' cross-chain
  reductions (the pooled Welford statistics, the step-size clip's median,
  the stretch move's partners, the loops' stopping tests) go through a
  reducer backed by collectives, and every random draw is made for all
  chains and sliced, so a sharded run draws what the unsharded run draws.
* **Data parallelism**: :func:`sharded_predict` splits the test points
  over the ranks and takes each rank's slice through ``GP.predict``'s
  device-side posterior (the solver's ``solve_columns``).
* **Row sharding** of one large dataset is the solvers' ``mesh=``
  (``HODLRSolver``, ``SparseSolver``).

Every function returns whole results on every rank.
"""

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from .collectives import all_reduce, gather_rows

__all__ = [
    "initialize",
    "chain_mesh",
    "shard_chains",
    "sharded_sample_nuts",
    "sharded_sample_hmc",
    "sharded_run_ensemble",
    "sharded_predict",
]


def _default_backend(local_world_size):
    """NCCL when each of a host's ranks has a GPU of its own, else gloo
    (NCCL refuses two ranks on one GPU)."""
    if torch.cuda.is_available() and (
            torch.cuda.device_count() >= local_world_size):
        return "nccl"
    return "gloo"


def initialize(**kwargs):
    """Join the process group (``torch.distributed.init_process_group``;
    ``kwargs`` go to it: ``init_method``, ``rank``, ``world_size``,
    ``store``, ``timeout``, ``backend``).

    Without ``backend`` it picks NCCL when every rank of the host has a
    GPU of its own (the host's ranks: ``LOCAL_WORLD_SIZE``, else the world
    size) and gloo otherwise. With CUDA, each rank's current
    device becomes ``local_rank % device_count``. It does nothing, and
    returns ``False``, when the group is already initialized or no
    rendezvous is configured (no ``init_method`` or ``store`` and no
    ``MASTER_ADDR`` in the environment); else it returns ``True``."""
    if dist.is_initialized():
        return False
    if not any(k in kwargs for k in ("init_method", "store")) and (
            "MASTER_ADDR" not in os.environ):
        return False
    env = os.environ
    world = int(kwargs.get("world_size", env.get("WORLD_SIZE", 1)))
    rank = int(kwargs.get("rank", env.get("RANK", 0)))
    local_world = int(env.get("LOCAL_WORLD_SIZE", world))
    backend = kwargs.pop("backend", None) or _default_backend(local_world)
    if torch.cuda.is_available():
        local_rank = int(env.get("LOCAL_RANK", rank % local_world))
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    kwargs.setdefault("timeout", datetime.timedelta(seconds=300))
    dist.init_process_group(backend=backend, **kwargs)
    return True


def chain_mesh(n_devices=None, axis="chains", device_type="cuda"):
    """A one-dimensional ``DeviceMesh`` named ``axis`` over the first
    ``n_devices`` ranks (default: all). Every rank must call it. A process
    that has joined no group gets a one-rank gloo group of its own, and
    so a one-rank mesh. ``device_type`` is where each rank's tensors live
    (default ``"cuda"``; ``"cpu"`` on a host without a card)."""
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if not 1 <= n <= world:
        raise ValueError("n_devices must be in [1, %d]" % world)
    return DeviceMesh(device_type, list(range(n)), mesh_dim_names=(axis,))


def _device(mesh):
    """This rank's device under ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _rank_rows(mesh, n):
    """``(start, stop)`` of this rank's contiguous block of ``n`` rows."""
    world, rank = mesh.size(), mesh.get_local_rank()
    if n % world:
        raise ValueError("%d rows do not split evenly over %d ranks"
                         % (n, world))
    size = n // world
    return rank * size, (rank + 1) * size


def shard_chains(mesh, array, dtype=None):
    """This rank's contiguous block of the leading axis of ``array`` (the
    same host array on every rank), as a tensor on this rank's device."""
    a, b = _rank_rows(mesh, np.shape(array)[0])
    t = torch.as_tensor(np.asarray(array)[a:b], dtype=dtype)
    return t.to(_device(mesh))


class MeshChains(object):
    """The samplers' cross-chain reducer (``sampling/_chains.py``) over the
    ranks of ``mesh``, each holding an equal block of the chains."""

    def __init__(self, mesh):
        self.group = mesh.get_group()
        self.world = mesh.size()
        self.rank = mesh.get_local_rank()

    def total(self, local):
        return local * self.world

    def rows(self, full):
        size = full.shape[0] // self.world
        return full[self.rank * size:(self.rank + 1) * size]

    def gather(self, local):
        return gather_rows(local, self.group)

    def sum(self, partial):
        return all_reduce(partial, self.group)

    def mean(self, local):
        return self.sum(torch.sum(local, dim=0)) / self.total(local.shape[0])

    def any(self, flags):
        # one all_reduce of one flag per call: every rank then takes the
        # same branch, so all ranks issue the same collectives
        count = flags.any().to(torch.int32).reshape(1)
        return bool(all_reduce(count, self.group)[0] > 0)


def _gather_stats(stats, chains):
    """A sampler's statistics over all chains: the per-chain arrays
    (chains on the last axis) gathered, the rest as they are."""
    out = {}
    for k, v in stats.items():
        if k == "step_size":
            out[k] = chains.gather(v)
        elif isinstance(v, torch.Tensor) and v.ndim == 2:
            out[k] = chains.gather(v.mT).mT
        else:
            out[k] = v
    return out


def _sharded_sample(mesh, key, log_prob_fn, p0, num_warmup, num_samples,
                    algorithm, opts):
    from ..sampling.hmc import _sample

    chains = MeshChains(mesh)
    q0 = shard_chains(mesh, p0)
    samples, stats = _sample(key, q0, log_prob_fn, int(num_warmup),
                             int(num_samples), algorithm=algorithm,
                             chains=chains, **opts)
    samples = chains.gather(samples.transpose(0, 1)).transpose(0, 1)
    return samples, _gather_stats(stats, chains)


def sharded_sample_nuts(mesh, key, log_prob_fn, p0, num_warmup=500,
                        num_samples=500, **opts):
    """NUTS (``sampling.sample_nuts``; options in ``opts``) with the chains
    of ``p0`` ``(chains, dim)``, a host array equal on every rank, split
    over the ranks of ``mesh``; ``chains`` must be a multiple of the mesh
    size. Each rank evaluates its own chains; the warmup's cross-chain
    reductions are collectives, and every rank issues them in the same
    order (the tree loops end when no chain of ANY rank goes on). Returns
    the whole ``(samples (num_samples, chains, dim), stats)`` on every
    rank, equal to the unsharded run's up to the order of the sums."""
    return _sharded_sample(mesh, key, log_prob_fn, p0, num_warmup,
                           num_samples, "nuts", opts)


def sharded_sample_hmc(mesh, key, log_prob_fn, p0, num_warmup=500,
                       num_samples=500, **opts):
    """Fixed-length HMC with the chains split over ``mesh`` (as
    :func:`sharded_sample_nuts`)."""
    return _sharded_sample(mesh, key, log_prob_fn, p0, num_warmup,
                           num_samples, "hmc", opts)


def sharded_run_ensemble(mesh, key, p0, log_prob_fn, nsteps, **opts):
    """The stretch-move ensemble (``sampling.run_ensemble``; ``opts``:
    ``thin``, ``a``) with the walkers of ``p0`` ``(nw, dim)``, a host
    array equal on every rank, split over ``mesh``. Each rank holds its
    block of EACH half of the ensemble, so every rank updates walkers on
    every half-step; a half-step gathers the other half's positions
    (walkers x dim) from all ranks for the partners. ``nw / 2`` must be a
    multiple of the mesh size. Returns the whole ``(chain, logps,
    accept)`` on every rank."""
    from ..sampling.ensemble import run_ensemble

    chains = MeshChains(mesh)
    p0 = np.asarray(p0)
    half = p0.shape[0] // 2
    a, b = _rank_rows(mesh, half)
    local = np.concatenate([p0[a:b], p0[half + a:half + b]])
    q0 = torch.as_tensor(local).to(_device(mesh))
    chain, logps, accs = run_ensemble(key, q0, log_prob_fn, int(nsteps),
                                      chains=chains, **opts)
    k = b - a

    def whole(t):
        # (steps, 2k, ...) -> (steps, nw, ...): each half gathered
        parts = [chains.gather(t[:, h * k:(h + 1) * k].transpose(0, 1))
                 .transpose(0, 1) for h in (0, 1)]
        return torch.cat(parts, dim=1)

    return whole(chain), whole(logps), accs


def sharded_predict(mesh, gp, y, t, return_var=True):
    """Posterior mean (and variance) at the test points ``t``, the test
    points split over the ranks of ``mesh``: each rank takes its slice
    through ``gp``'s own device-side posterior (the cross covariance, the
    solver's ``solve_columns`` and the float64 reductions of
    ``GP.predict``), and the ranks gather the results (the test points are
    padded to a multiple of the mesh size). ``gp`` is computed the same on
    every rank, with a single-process solver. Returns whole arrays on every
    rank."""
    gp.recompute()
    if getattr(gp.solver, "_shard", None) is not None or getattr(
            gp.solver, "mesh", None) is not None:
        raise ValueError(
            "the solver splits its rows over a mesh already; predict "
            "through gp.predict, which every rank of that mesh calls")
    alpha = gp._alpha_device(np.asarray(y), True)
    ts = gp.parse_samples(t)
    world = mesh.size()
    n_t = len(ts)
    pad = (-n_t) % world
    ts_padded = np.concatenate([ts, np.repeat(ts[-1:], pad, axis=0)])
    a, b = _rank_rows(mesh, len(ts_padded))
    mu, var = gp._posterior(gp.kernel, ts_padded[a:b], alpha,
                            "var" if return_var else None)
    group = mesh.get_group()
    mu = gather_rows(mu, group).cpu().numpy()[:n_t] + gp._call_mean(ts)
    if return_var:
        return mu, gather_rows(var, group).cpu().numpy()[:n_t]
    return mu
