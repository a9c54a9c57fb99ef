# -*- coding: utf-8 -*-
"""Entry points of the port: the single-device forward step and a
multi-rank dry run, as the JAX package has them beside it
(``entry()``, ``dryrun_multichip(n)``).

``entry()`` returns the flagship forward step, the fused GP marginal
log-likelihood and its gradient (assemble, Cholesky, solve, log-determinant
in one autograd pass) on a quasi-periodic 1-D model at n = 1024, with
example arguments on the device.

``dryrun_multichip(n)`` spawns ``n`` ranks on the card (``device="cpu"``:
gloo ranks on the CPU) and runs the sharded training steps over an
``n``-rank mesh: one stretch-move ensemble sweep of the GP hyperparameter
posterior with the walkers split over the ranks, a short chain-sharded
NUTS run, and the row-sharded hierarchical solver's likelihood and
gradient. Run it as ``python -m george_tpu_torch.entry N [cuda|cpu]``.
"""

import socket
import sys
import traceback

import numpy as np
import torch

__all__ = ["entry", "dryrun_multichip"]


def _make_gp(device):
    from . import GP, kernels

    kernel = 0.5 * kernels.ExpSquaredKernel(1.3) * kernels.ExpSine2Kernel(
        gamma=2.0, log_period=0.0
    ) + 0.1 * kernels.Matern32Kernel(2.0)
    return GP(kernel, mean=0.0, white_noise=np.log(1e-4),
              fit_white_noise=True, device=device)


def _make_data(n, seed=42):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0.0, 30.0, n))
    y = np.sin(x) * np.exp(-0.05 * x) + 0.1 * rng.standard_normal(n)
    yerr2 = np.full(n, 0.01)
    return x[:, None], y, yerr2


def entry(device="cuda"):
    """``(forward, example_args)``: ``forward(theta, x, y, yerr2) -> (ll,
    d ll / d theta)`` over the full parameter vector, on ``device``."""
    gp = _make_gp(device)
    x, y, yerr2 = _make_data(1024)
    loglike = gp._fused_loglike_full()

    def forward(theta, x, y, yerr2):
        g, ll = torch.func.grad_and_value(loglike)(theta, x, y, yerr2)
        return ll, g

    args = tuple(gp._tensor(a) for a in (
        gp.get_parameter_vector(include_frozen=True), x, y, yerr2))
    return forward, args


def _dryrun_rank(rank, world, port, device, out):
    """One rank of :func:`dryrun_multichip` on ``device`` (``"cuda"`` or
    ``"cpu"``); writes its summary (or its traceback) to ``out[rank]``."""
    try:
        torch.set_num_threads(1)
        from . import GP, HODLRSolver, kernels, parallel
        from .sampling import run_ensemble

        # on the card the backend is picked as for any run (NCCL with a
        # card per rank, else gloo); CPU ranks take gloo
        parallel.initialize(init_method="tcp://127.0.0.1:%d" % port,
                            rank=rank, world_size=world,
                            backend="gloo" if device == "cpu" else None)
        mesh = parallel.chain_mesh(device_type=device)
        gp = _make_gp(device)
        x, y, yerr2 = _make_data(128)
        gp.compute(x, np.sqrt(yerr2))
        log_prob = torch.func.vmap(
            gp.log_prob_fn(x, y, np.sqrt(yerr2), gate_prior=False))
        ndim = len(gp)
        nwalkers = max(2 * world, 2 * ndim + 2)
        nwalkers = -(-nwalkers // (2 * world)) * (2 * world)
        p0 = (gp.get_parameter_vector()[None, :] + 1e-3
              * np.random.default_rng(0).standard_normal((nwalkers, ndim)))

        # the training step: one ensemble sweep, walkers over the ranks,
        # against the same sweep unsharded
        walkers, logp, acc = parallel.sharded_run_ensemble(
            mesh, 0, p0, log_prob, 1)
        ref, ref_logp, _ = run_ensemble(
            0, torch.as_tensor(p0, device=walkers.device), log_prob, 1)
        assert walkers.shape == (1, nwalkers, ndim)
        assert bool(torch.isfinite(logp).all())
        ens_err = float((walkers - ref).abs().max())

        # chain-sharded NUTS
        single = gp.log_prob_fn(x, y, np.sqrt(yerr2), gate_prior=False)
        samples, _ = parallel.sharded_sample_nuts(
            mesh, 1, single, p0[:2 * world], num_warmup=4, num_samples=2,
            max_depth=4)
        assert samples.shape == (2, 2 * world, ndim)
        assert bool(torch.isfinite(samples).all())

        # the row-sharded hierarchical solver
        rngd = np.random.default_rng(3)
        nd = 128 * max(world, 2)
        xd = np.sort(rngd.uniform(0.0, 60.0, nd))
        yd = np.sin(0.5 * xd) + 0.3 * rngd.standard_normal(nd)
        gp_dp = GP(1.0 * kernels.ExpSquaredKernel(4.0), solver=HODLRSolver,
                   min_size=32, rank=16, mesh=mesh, device=device)
        gp_dp.compute(xd, 0.3)
        ll = gp_dp.log_likelihood(yd)
        grad = gp_dp.grad_log_likelihood(yd)
        assert np.isfinite(ll) and np.all(np.isfinite(grad))
        out[rank] = {"rank": rank, "world": world, "nwalkers": nwalkers,
                     "ensemble_vs_unsharded": ens_err,
                     "accept": float(acc[0]), "hodlr_ll": float(ll),
                     "hodlr_sharded": gp_dp.solver._shard is not None}
        import torch.distributed as dist

        dist.destroy_process_group()
    except Exception:      # reported to the parent, which raises
        out[rank] = {"rank": rank, "error": traceback.format_exc()}


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dryrun_multichip(n_devices, timeout=600, device="cuda"):
    """Run the sharded training steps on ``n_devices`` spawned ranks on
    ``device`` (``"cuda"``: rank r on card ``r % device_count``, NCCL when
    each rank has a card of its own, else gloo; ``"cpu"``: gloo CPU
    ranks) and return rank 0's summary; raises if any rank fails or the
    ranks do not finish within ``timeout`` seconds."""
    device = torch.device(device).type
    if device not in ("cuda", "cpu"):
        raise ValueError("dryrun_multichip runs on 'cuda' or 'cpu', not %r"
                         % device)
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    world = int(n_devices)
    with ctx.Manager() as manager:
        out = manager.dict()
        port = _free_port()
        procs = [ctx.Process(target=_dryrun_rank,
                             args=(r, world, port, device, out))
                 for r in range(world)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout)
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.kill()
            p.join()
        results = dict(out)
    errors = [r["error"] for r in results.values() if "error" in r]
    if hung or errors or len(results) != world:
        raise RuntimeError(
            "dryrun_multichip(%d) failed: %d ranks hung, %d reported\n%s"
            % (world, len(hung), len(results), "\n".join(errors)))
    return results[0]


if __name__ == "__main__":
    print(dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 2,
                           device=sys.argv[2] if len(sys.argv) > 2
                           else "cuda"))
