# -*- coding: utf-8 -*-
"""One rank of the gloo CPU groups of ``tests/test_torch_parallel.py``.

Run as::

    python tests/_torch_parallel_worker.py RANK WORLD PORT WORKDIR

with the repository root on ``PYTHONPATH``. The rank joins a ``WORLD``-rank
gloo group at ``tcp://127.0.0.1:PORT`` through
``george_tpu_torch.parallel.initialize``, runs every scenario below on the
mesh over it, and pickles ``{scenario: result}`` to
``WORKDIR/out_WORLD_RANK.pkl``. ``WORKDIR/inputs.npz`` holds what the
parent computes with the JAX package while the sampler scenarios run: its
HODLR skeleton pivots and its Rademacher probes, so that the two packages
factor the same structure and draw the same probes; the scenarios that
need them wait for the file. This module imports neither JAX nor the JAX
package; the parent holds the results against them.
"""

import datetime
import os
import pickle
import sys
import time
import traceback

import numpy as np
import torch

DEV = "cpu"


# ---------------------------------------------------------------------------
# Data (numpy only: the parent builds the JAX references from the same)
# ---------------------------------------------------------------------------

def dense_problem():
    rng = np.random.default_rng(3)
    x = np.sort(rng.uniform(0, 10, 80))
    y = np.sin(x) + 0.1 * rng.standard_normal(80)
    return x, y, 0.1, np.linspace(0, 10, 101)   # 101 points: not a multiple


def hodlr_predict_problem():
    rng = np.random.default_rng(4)
    x = np.sort(rng.uniform(0, 20, 300))
    y = np.sin(x) + 0.1 * rng.standard_normal(300)
    return x, y, 0.1, np.linspace(0, 20, 101)


def sparse_predict_problem():
    rng = np.random.default_rng(5)
    x = np.sort(rng.uniform(0, 30, 300))
    y = np.sin(0.5 * x) + 0.1 * rng.standard_normal(300)
    return x, y, 0.2, np.linspace(0, 30, 101)


def hmatrix_problem():
    rng = np.random.default_rng(6)
    x = rng.uniform(0, 10, (500, 2))
    y = np.sin(x[:, 0]) + 0.1 * rng.standard_normal(500)
    return x, y, 0.1, rng.uniform(0, 10, (101, 2))


def hodlr_mesh_problem():
    rng = np.random.default_rng(21)
    n = 2000
    x = np.sort(rng.uniform(0, 60, n))
    y = np.sin(0.5 * x) + 0.3 * rng.standard_normal(n)
    return x, y, 0.3, np.linspace(0, 60, 50)


def sparse_mesh_problem(n=301, seed=0):
    """``tests/test_sparse.py::_sparse_problem`` at an odd n, so the rows
    need padding on every mesh."""
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0, 40, n))[:, None]
    yerr = 0.3 * np.ones(n)
    y = np.sin(x[:, 0]) + 0.3 * rng.standard_normal(n)
    return x, y, yerr


SPARSE_MESH_KW = {"num_probes": 64, "num_steps": 40, "direct": False}
# the chains of the sparse log_prob scenario: the computed parameters and
# a step away from them
SPARSE_LOG_PROB_SHIFTS = [[0.0, 0.0, 0.0], [0.1, -0.05, 0.05]]
HODLR_MESH_KW = {"min_size": 64, "rank": 24}
HODLR_PREDICT_KW = {"min_size": 64, "rank": 48}


def kernels_for(pkg):
    """The kernels of the scenarios, built from either package."""
    k = pkg.kernels
    return {
        "dense": lambda: 1.0 * k.ExpSquaredKernel(1.0),
        "hodlr_predict": lambda: 1.0 * k.ExpSquaredKernel(1.5),
        "sparse_predict": lambda: k.WendlandC2Kernel(
            log_rc=np.log(4.0), kernel_base=1.0 * k.ExpSquaredKernel(2.0)),
        "hmatrix": lambda: 1.0 * k.ExpSquaredKernel([1.5, 1.5], ndim=2),
        "hodlr_mesh": lambda: 1.0 * k.ExpSquaredKernel(4.0),
        "sparse_mesh": lambda: k.WendlandC2Kernel(
            log_rc=np.log(4.0), kernel_base=1.2 * k.ExpSquaredKernel(2.0)),
    }


# ---------------------------------------------------------------------------
# Scenarios (every rank runs each; each returns plain numpy / floats)
# ---------------------------------------------------------------------------

def _install_pivots(levels):
    """Make the port's HODLR solvers adopt ``levels`` (a list of
    ``(row_piv, col_piv)``) instead of walking ACA; returns the undo."""
    from george_tpu_torch.solvers import hodlr as TH

    original = TH.select_aca_pivots

    def given(pair_fn, theta, xpad, valid, struct):
        for lev, (rp, cp) in zip(struct.levels, levels):
            lev["row_piv"] = np.asarray(rp)
            lev["col_piv"] = np.asarray(cp)
        struct._build_flat()

    TH.select_aca_pivots = given
    return lambda: setattr(TH, "select_aca_pivots", original)


def _levels(inputs, name):
    L = int(inputs[name + "_L"])
    return [(inputs["%s_r%d" % (name, i)], inputs["%s_c%d" % (name, i)])
            for i in range(L)]


def scenario_nuts_gaussian(mesh, inputs):
    from george_tpu_torch import parallel

    def log_prob(theta):
        return -0.5 * torch.sum(theta ** 2)

    p0 = np.random.default_rng(0).standard_normal((2 * mesh.size(), 3))
    samples, stats = parallel.sharded_sample_nuts(
        mesh, 0, log_prob, p0, num_warmup=200, num_samples=300, max_depth=6)
    flat = samples.reshape(-1, 3).numpy()
    return {"shape": tuple(samples.shape), "mean": flat.mean(0),
            "std": flat.std(0), "leapfrog_evals": stats["leapfrog_evals"]}


def _gaussian4():
    rng = np.random.default_rng(3)
    A = rng.standard_normal((4, 4))
    prec = torch.as_tensor(np.linalg.inv(A @ A.T + 0.3 * np.eye(4)))
    return (lambda q: -0.5 * q @ (prec @ q)), rng


def scenario_dense_mass_nuts(mesh, inputs):
    """The JAX package's dense-mass comparison (150 + 100 steps), against
    the unsharded run evaluating its chains in batches of the shard's
    count (2), the batch each rank evaluates."""
    from george_tpu_torch import parallel
    from george_tpu_torch.sampling.hmc import _sample

    log_prob, rng = _gaussian4()
    p0 = rng.standard_normal((2 * mesh.size(), 4))
    kw = dict(max_depth=6, dense_mass=True)
    s_ref, st_ref = _sample(5, torch.as_tensor(p0), log_prob, 150, 100,
                            _chain_batch=2, **kw)
    s_sh, st_sh = parallel.sharded_sample_nuts(
        mesh, 5, log_prob, p0, num_warmup=150, num_samples=100, **kw)
    return {"samples": (s_ref.numpy(), s_sh.numpy()),
            "step_size": (st_ref["step_size"].numpy(),
                          st_sh["step_size"].numpy()),
            "sigma": (st_ref["inv_mass"]["sigma"].numpy(),
                      st_sh["inv_mass"]["sigma"].numpy()),
            "evals": (st_ref["leapfrog_evals"], st_sh["leapfrog_evals"])}


def scenario_nuts_transitions(mesh, inputs):
    """NUTS and HMC transitions alone (no warmup): every draw of a chain
    is made for all chains and sliced, and the trees end together."""
    from george_tpu_torch import parallel
    from george_tpu_torch.sampling import sample_hmc, sample_nuts

    log_prob, rng = _gaussian4()
    p0 = rng.standard_normal((4 * mesh.size(), 4))
    out = {}
    for name, ref_fn, sh_fn, kw in (
            ("nuts", sample_nuts, parallel.sharded_sample_nuts,
             dict(max_depth=6, dense_mass=True)),
            ("hmc", sample_hmc, parallel.sharded_sample_hmc,
             dict(num_leapfrog=8))):
        s_ref, st_ref = ref_fn(7, log_prob, torch.as_tensor(p0),
                               num_warmup=0, num_samples=60, **kw)
        s_sh, st_sh = sh_fn(mesh, 7, log_prob, p0, num_warmup=0,
                            num_samples=60, **kw)
        out[name] = {"samples": (s_ref.numpy(), s_sh.numpy()),
                     "accept": (st_ref["accept"].numpy(),
                                st_sh["accept"].numpy()),
                     "evals": (st_ref["leapfrog_evals"],
                               st_sh["leapfrog_evals"])}
    return out


def scenario_ensemble(mesh, inputs):
    from george_tpu_torch import parallel
    from george_tpu_torch.sampling import run_ensemble

    icov = torch.as_tensor(np.linalg.inv(np.array([[2.0, 0.3],
                                                   [0.3, 0.5]])))
    batched = torch.func.vmap(lambda th: -0.5 * th @ icov @ th)
    p0 = np.random.default_rng(1).standard_normal((4 * mesh.size(), 2))
    ref = run_ensemble(2, torch.as_tensor(p0), batched, 50)
    sh = parallel.sharded_run_ensemble(mesh, 2, p0, batched, 50)
    return {k: (a.numpy(), b.numpy())
            for k, a, b in zip(("chain", "logp", "accept"), ref, sh)}


def scenario_shard_chains(mesh, inputs):
    from george_tpu_torch import parallel
    from george_tpu_torch.parallel.collectives import gather_rows

    arr = np.arange(4 * mesh.size() * 7, dtype=np.float64).reshape(-1, 7)
    local = parallel.shard_chains(mesh, arr)
    return {"local": local.numpy(), "device": str(local.device),
            "gathered": gather_rows(local, mesh.get_group()).numpy(),
            "rank": mesh.get_local_rank(), "arr": arr}


def _predict(mesh, gp, problem):
    from george_tpu_torch import parallel

    x, y, yerr, t = problem
    gp.compute(x, yerr)
    mu, var = parallel.sharded_predict(mesh, gp, y, t)
    mu_1, var_1 = gp.predict(y, t, return_var=True)
    return {"mu": mu, "var": var, "mu_1": mu_1, "var_1": var_1}


def scenario_predict(mesh, inputs):
    """``sharded_predict`` on every solver path; ``*_1`` is the port's own
    ``gp.predict`` on the same rank."""
    from george_tpu_torch import GP, HMatrixSolver, HODLRSolver, SparseSolver
    import george_tpu_torch as tgt

    K = kernels_for(tgt)
    out = {"dense": _predict(mesh, GP(K["dense"](), device=DEV),
                             dense_problem())}
    for name, kw in (("hodlr", {}), ("hodlr_sym", {"sym": True})):
        undo = _install_pivots(_levels(inputs, "piv_" + name))
        try:
            out[name] = _predict(mesh, GP(
                K["hodlr_predict"](), solver=HODLRSolver, device=DEV,
                **HODLR_PREDICT_KW, **kw), hodlr_predict_problem())
        finally:
            undo()
    for name, kw in (("sparse", {}), ("sparse_cg", {"direct": False})):
        out[name] = _predict(mesh, GP(K["sparse_predict"](),
                                      solver=SparseSolver, device=DEV, **kw),
                             sparse_predict_problem())
    out["hmatrix"] = _predict(mesh, GP(
        K["hmatrix"](), solver=HMatrixSolver, min_size=64, rank=16,
        precond_rank=64, device=DEV), hmatrix_problem())
    return out


def scenario_hodlr_mesh(mesh, inputs):
    """``HODLRSolver(mesh=)``: with the JAX package's pivots (against its
    unsharded GP in the parent), with the port's own ACA pivots against
    the port's unsharded GP, the Hutchinson gradient, ``log_prob_fn``
    under the samplers' ``vmap`` and a leaf count that does not split."""
    from george_tpu_torch import GP, HODLRSolver
    import george_tpu_torch as tgt

    K = kernels_for(tgt)["hodlr_mesh"]
    x, y, yerr, t = hodlr_mesh_problem()
    out = {}

    def run(tag, **kw):
        gp = GP(K(), solver=HODLRSolver, device=DEV, **HODLR_MESH_KW, **kw)
        gp.compute(x, yerr)
        mu, var = gp.predict(y, t, return_var=True)
        out[tag] = {"ll": gp.log_likelihood(y),
                    "grad": gp.grad_log_likelihood(y), "mu": mu, "var": var,
                    "sharded": gp.solver._shard is not None,
                    "leaves": gp.solver._factors["Lleaf"].shape[0]}
        return gp

    def functions(gp):
        """The functional Hutchinson likelihood and the refined solve on
        the solver's structure (sharded or not), on shared probes."""
        from george_tpu_torch.solvers import hodlr as TH

        s, st = gp.solver, gp.solver._struct
        r = np.zeros(st.n_pad)
        r[:st.n] = (y - gp._call_mean(gp._x))[s._perm]
        r_pad = s._tensor(r)
        probes = np.random.default_rng(8).choice([-1.0, 1.0],
                                                 (6, st.n_pad))
        args = (gp.kernel.pair_fn, s._theta, s._xpad, s._valid, s._diag_pad)
        ll, g = TH.hodlr_loglike_and_grad_hutchinson(
            *args, r_pad, st, probes=probes, refine_steps=1)
        z = TH.hodlr_solve_refined(*args, st, s._factors,
                                   TH._rows(st, r_pad), steps=2)
        return {"ll": float(ll), "grad": g.numpy(),
                "solve": s._gather(z).numpy()}

    undo = _install_pivots(_levels(inputs, "piv_hodlr_mesh"))
    try:
        out["functions_1"] = functions(run("jax_pivots_1"))
        out["functions"] = functions(run("jax_pivots", mesh=mesh))
        for tag, kw in (("hutchinson_1", {}), ("hutchinson", {"mesh": mesh})):
            gp = GP(K(), solver=HODLRSolver, device=DEV,
                    grad_mode="hutchinson", **HODLR_MESH_KW, **kw)
            gp.compute(x, yerr)
            out[tag] = gp.grad_log_likelihood(y)
    finally:
        undo()
    run("aca_1")
    gp = run("aca", mesh=mesh)

    # the samplers' batched evaluator through the sharded factorization
    thetas = torch.as_tensor(gp.get_parameter_vector())[None, :] + (
        0.05 * torch.arange(3, dtype=torch.float64)[:, None])
    vg = {}
    for tag, solver_gp in (("sharded", gp), ("one", None)):
        if solver_gp is None:
            solver_gp = GP(K(), solver=HODLRSolver, device=DEV,
                           **HODLR_MESH_KW)
            solver_gp.compute(x, yerr)
        lp = solver_gp.log_prob_fn(x, y, yerr)
        g, v = torch.func.vmap(torch.func.grad_and_value(lp))(thetas)
        vg[tag] = (g.detach().numpy(), v.detach().numpy())
    out["log_prob_vmap"] = vg
    # a leaf count that does not split over the ranks: warns, unsharded
    import warnings

    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        odd = GP(K(), solver=HODLRSolver, device=DEV, min_size=64, rank=24,
                 mesh=mesh)
        odd.compute(x[:100], yerr)
        out["odd"] = {"sharded": odd.solver._shard is not None,
                      "warned": any("unsharded" in str(m.message)
                                    for m in w),
                      "ll": odd.log_likelihood(y[:100])}
    return out


def sym_rows():
    """The rows ``apply_sqrt`` transports and the columns the ``W^{-1}``
    applications take in the symmetric scenario."""
    rng = np.random.default_rng(23)
    n = len(hodlr_mesh_problem()[0])
    return rng.standard_normal((8, n)), rng.standard_normal((n, 3))


SAMPLE_SEED = 31


def _sym_surface(gp, y, t):
    """What the symmetric scenario holds of a ``sym=True`` GP."""
    s = gp.solver
    R, Y = sym_rows()
    mu, var = gp.predict(y, t, return_var=True)
    np.random.seed(SAMPLE_SEED)
    return {"ll": gp.log_likelihood(y), "logdet": s.log_determinant,
            "grad": gp.grad_log_likelihood(y), "mu": mu, "var": var,
            "sqrt": s.apply_sqrt(R), "winv": s.apply_inverse_sym_W(Y),
            "winvt": s.apply_inverse_sym_W_transpose(Y),
            "sample": gp.sample(), "sharded": s._shard is not None,
            "leaves": s._factors["Lleaf"].shape[0]}


def _sym_functions(gp, y):
    """Reverse mode and ``vmap`` through :func:`hodlr_factor_sym` on the
    solver's structure (sharded or not): ``f(theta) = r^T W^{-T} W^{-1} r
    + log det K`` and its gradient at the solver's theta and, in one
    ``vmap``, at two shifted thetas. A level whose pairs span ranks
    reaches theta through ``gather_rows``. (At the scenario's rank 24 the
    smallest coupling singular values round ``1 +- sigma`` to equal core
    eigenvalues, where ``eigh``'s derivative is not defined; the caller
    uses rank 8.)"""
    from george_tpu_torch.solvers import hodlr as TH

    s, st = gp.solver, gp.solver._struct
    r = np.zeros(st.n_pad)
    r[:st.n] = (y - gp._call_mean(gp._x))[s._perm]
    r_loc = TH._rows(st, s._tensor(r))
    pair = gp.kernel.pair_fn

    def f(theta):
        fac, ld = TH.hodlr_factor_sym(pair, theta, s._xpad, s._valid,
                                      s._diag_pad, st)
        w = TH.hodlr_sqrt_solve(fac, st, r_loc)
        return TH._rowsum(st, torch.dot(w, w)) + ld

    theta = s._theta
    thetas = theta[None, :] + 0.05 * torch.arange(
        2, dtype=theta.dtype)[:, None]
    g, v = torch.func.grad_and_value(f)(theta)
    gb, vb = torch.func.vmap(torch.func.grad_and_value(f))(thetas)
    return {"value": float(v), "grad": g.numpy(), "vmap_value": vb.numpy(),
            "vmap_grad": gb.numpy()}


def scenario_gather_rows(mesh, inputs):
    """``gather_rows``'s adjoints: ``f(X) = sum(w * X^3)`` of the gathered
    rows, its gradient in this rank's block, its ``jvp`` and its ``vmap``
    over a batch of blocks, with the whole-array results computed here
    beside them."""
    from george_tpu_torch.parallel.collectives import gather_rows

    group, world, rank = mesh.get_group(), mesh.size(), mesh.get_local_rank()
    rng = np.random.default_rng(9)
    X = torch.as_tensor(rng.standard_normal((2, 4 * world, 3)))
    w = torch.as_tensor(rng.standard_normal((4 * world, 3)))
    T = torch.as_tensor(rng.standard_normal((4 * world, 3)))
    own = slice(4 * rank, 4 * (rank + 1))

    def f(xl):
        return torch.sum(w * gather_rows(xl, group) ** 3)

    def f_whole(x):
        return torch.sum(w * x ** 3)

    g = torch.func.grad(f)(X[0, own])
    _, dv = torch.func.jvp(f, (X[0, own],), (T[own],))
    vb = torch.func.vmap(f)(X[:, own])
    return {"grad": (g.numpy(), torch.func.grad(f_whole)(X[0])[own].numpy()),
            "jvp": (float(dv),
                    float(torch.func.jvp(f_whole, (X[0],), (T,))[1])),
            "vmap": (vb.numpy(), torch.func.vmap(f_whole)(X).numpy())}


def scenario_hodlr_mesh_sym(mesh, inputs):
    """``HODLRSolver(mesh=, sym=True)`` and the unsharded port's: on the
    JAX package's pivots the surface of :func:`_sym_surface` and the
    symmetric Hutchinson gradient; at rank 8 on the port's own pivots
    (rank 0's) :func:`_sym_functions`."""
    from george_tpu_torch import GP, HODLRSolver
    import george_tpu_torch as tgt

    K = kernels_for(tgt)["hodlr_mesh"]
    x, y, yerr, t = hodlr_mesh_problem()
    out = {}
    undo = _install_pivots(_levels(inputs, "piv_hodlr_mesh"))
    try:
        for tag, kw in (("one", {}), ("sharded", {"mesh": mesh})):
            gp = GP(K(), solver=HODLRSolver, device=DEV, sym=True,
                    **HODLR_MESH_KW, **kw)
            gp.compute(x, yerr)
            out[tag] = _sym_surface(gp, y, t)
            gp = GP(K(), solver=HODLRSolver, device=DEV, sym=True,
                    grad_mode="hutchinson", **HODLR_MESH_KW, **kw)
            gp.compute(x, yerr)
            out[tag]["hutchinson"] = gp.grad_log_likelihood(y)
    finally:
        undo()
    for tag, kw in (("one", {}), ("sharded", {"mesh": mesh})):
        gp = GP(K(), solver=HODLRSolver, device=DEV, sym=True, min_size=64,
                rank=8, **kw)
        gp.compute(x, yerr)
        out[tag]["functions"] = _sym_functions(gp, y)
    return out


def scenario_sparse_mesh_log_prob(mesh, inputs):
    """``SparseSolver(mesh=).loglike_fn`` through ``GP.log_prob_fn`` with
    the JAX package's probes, sharded and on one rank: value and gradient
    at the computed parameters and a step away (``loop``), and, sharded,
    ``vmap`` over the 2 chains."""
    from george_tpu_torch import GP, SparseSolver
    import george_tpu_torch as tgt

    x, y, yerr = sparse_mesh_problem()
    K = kernels_for(tgt)["sparse_mesh"]
    out = {}
    for tag, kw in (("one", {}), ("sharded", {"mesh": mesh})):
        gp = GP(K(), solver=SparseSolver, device=DEV, **SPARSE_MESH_KW,
                probes=inputs["sparse_probes"], **kw)
        gp.compute(x, yerr)
        lp = gp.log_prob_fn(x, y, yerr)
        thetas = torch.as_tensor(gp.get_parameter_vector())[None, :] + (
            torch.as_tensor(SPARSE_LOG_PROB_SHIFTS))
        loop = [torch.func.grad_and_value(lp)(th) for th in thetas]
        out[tag] = {"value": np.array([float(v) for _, v in loop]),
                    "grad": np.stack([g.numpy() for g, _ in loop]),
                    "sharded": gp.solver._shard is not None}
    gb, vb = torch.func.vmap(torch.func.grad_and_value(lp))(thetas)
    out["sharded"].update(vmap_value=vb.numpy(), vmap_grad=gb.numpy())
    return out


def scenario_sparse_mesh(mesh, inputs):
    """``SparseSolver(mesh=)`` with the JAX package's probes, unsharded and
    sharded, and the direct path's refusal of a mesh."""
    from george_tpu_torch import GP, SparseSolver
    import george_tpu_torch as tgt

    x, y, yerr = sparse_mesh_problem()
    K = kernels_for(tgt)["sparse_mesh"]
    probes = {"probes": inputs["sparse_probes"],
              "grad_probes": inputs["sparse_grad_probes"]}
    out = {}
    for tag, kw in (("one", {}), ("sharded", {"mesh": mesh})):
        gp = GP(K(), solver=SparseSolver, device=DEV, **SPARSE_MESH_KW,
                **probes, **kw)
        gp.compute(x, yerr)
        out[tag] = {"ll": gp.log_likelihood(y),
                    "grad": gp.grad_log_likelihood(y),
                    "logdet": gp.solver.log_determinant,
                    "sharded": gp.solver._shard is not None,
                    "rows": gp.solver._nbr.shape[0],
                    "sample": gp.solver.apply_sqrt(np.eye(len(x))[:2])}
    refusals = {}
    try:
        GP(K(), solver=SparseSolver, device=DEV, direct=True,
           mesh=mesh).compute(x, yerr)
    except ValueError:
        refusals["direct"] = True
    out["refusals"] = refusals
    return out


# in order: those that need the parent's inputs last
SCENARIOS = {
    "dense_mass_nuts": scenario_dense_mass_nuts,
    "nuts_transitions": scenario_nuts_transitions,
    "ensemble": scenario_ensemble,
    "shard_chains": scenario_shard_chains,
    "nuts_gaussian": scenario_nuts_gaussian,
    "predict": scenario_predict,
    "hodlr_mesh": scenario_hodlr_mesh,
    "sparse_mesh": scenario_sparse_mesh,
    "hodlr_mesh_sym": scenario_hodlr_mesh_sym,
    "gather_rows": scenario_gather_rows,
    "sparse_mesh_log_prob": scenario_sparse_mesh_log_prob,
}
NEEDS_INPUTS = ("predict", "hodlr_mesh", "sparse_mesh", "hodlr_mesh_sym",
                "sparse_mesh_log_prob")


def _inputs(workdir, timeout=300.0):
    """The parent's inputs, once it has written them."""
    path = os.path.join(workdir, "inputs.npz")
    t0 = time.perf_counter()
    while not os.path.exists(path):
        if time.perf_counter() - t0 > timeout:
            raise RuntimeError("no %s after %.0f s" % (path, timeout))
        time.sleep(0.2)
    return dict(np.load(path))


def main():
    rank, world, port = (int(a) for a in sys.argv[1:4])
    workdir = sys.argv[4]
    torch.set_num_threads(1)
    from george_tpu_torch import parallel

    parallel.initialize(init_method="tcp://127.0.0.1:%d" % port, rank=rank,
                        world_size=world, backend="gloo",
                        timeout=datetime.timedelta(seconds=120))
    mesh = parallel.chain_mesh(device_type="cpu")
    results, inputs = {}, None
    for name, fn in SCENARIOS.items():
        t0 = time.perf_counter()
        if name in NEEDS_INPUTS and inputs is None:
            inputs = _inputs(workdir)
        try:
            results[name] = fn(mesh, inputs)
        except Exception:
            results[name] = {"error": traceback.format_exc()}
        print("%s %.1f s" % (name, time.perf_counter() - t0), flush=True)
    with open(os.path.join(workdir, "out_%d_%d.pkl" % (world, rank)),
              "wb") as f:
        pickle.dump(results, f)
    import torch.distributed as dist

    dist.destroy_process_group()


if __name__ == "__main__":
    main()
