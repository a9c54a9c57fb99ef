# -*- coding: utf-8 -*-
"""``george_tpu_torch.parallel`` and the solvers' ``mesh=`` on gloo groups
of 2 and 4 CPU ranks, against the JAX package (float64).

Each group is spawned once per module (``tests/_torch_parallel_worker.py``,
one process per rank) and runs every scenario; each test below reads one
scenario's results. The counterparts of ``tests/test_parallel.py`` and
``tests/test_distributed.py``: NUTS on a Gaussian, the ensemble sharded
against unsharded, ``sharded_predict`` on every solver path against the
JAX ``gp.predict``, ``shard_chains``, ``HODLRSolver(mesh=)`` on n = 2000
against the JAX unsharded GP, dense-mass NUTS sharded against unsharded,
``SparseSolver(mesh=)`` against the JAX unsharded solver, the symmetric
factorization (``sym=True``, ``apply_sqrt``, ``GP.sample``) and the sparse
``log_prob_fn`` under ``mesh=`` against the JAX package, ``gather_rows``'s
adjoints, every rank's results equal (SPMD determinism) and
``dryrun_multichip``.
"""

import os
import pickle
import socket
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import george_tpu as jgt
import george_tpu_torch as tgt
from george_tpu_torch import parallel

import _torch_parallel_worker as W

jax.config.update("jax_enable_x64", True)

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
WORLDS = (2, 4)
SPAWN_TIMEOUT = 400     # seconds for a whole group; gloo's own is 120


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _jax_pivots(gp, name, out):
    levels = gp.solver._struct.levels
    out[name + "_L"] = np.array(len(levels))
    for i, lev in enumerate(levels):
        out["%s_r%d" % (name, i)] = np.asarray(lev["row_piv"])
        out["%s_c%d" % (name, i)] = np.asarray(lev["col_piv"])


def _jax_predict(gp, problem):
    x, y, yerr, t = problem
    gp.compute(x, yerr)
    return gp.predict(y, t, return_var=True)


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """Spawn both groups and the dry run, compute what the ranks need from
    the JAX package and the JAX references meanwhile, and return
    ``{"ranks": {world: [results of each rank]}, "ref": {...},
    "dryrun": summary or exception}``."""
    workdir = str(tmp_path_factory.mktemp("parallel"))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    env["OMP_NUM_THREADS"] = "1"
    procs = {}
    for world in WORLDS:
        port = _free_port()
        procs[world] = [subprocess.Popen(
            [sys.executable, os.path.join(HERE, "_torch_parallel_worker.py"),
             str(rank), str(world), str(port), workdir],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
            text=True) for rank in range(world)]
    dryrun = {}

    def run_dryrun():
        from george_tpu_torch.entry import dryrun_multichip

        try:
            dryrun["out"] = dryrun_multichip(2, timeout=SPAWN_TIMEOUT,
                                             device="cpu")
        except Exception as e:      # re-raised by its test
            dryrun["out"] = e

    thread = threading.Thread(target=run_dryrun)
    thread.start()

    K = W.kernels_for(jgt)
    JH = jgt.HODLRSolver
    # what the ranks need from the JAX package (they wait for the file)
    inputs, ref = {}, {}
    gp_h = {}
    for name, kw in (("hodlr", {}), ("hodlr_sym", {"sym": True})):
        gp_h[name] = jgt.GP(K["hodlr_predict"](), solver=JH,
                            **W.HODLR_PREDICT_KW, **kw)
        x, _, yerr, _ = W.hodlr_predict_problem()
        gp_h[name].compute(x, yerr)
        _jax_pivots(gp_h[name], "piv_" + name, inputs)
    x, y, yerr, t = W.hodlr_mesh_problem()
    gj = jgt.GP(K["hodlr_mesh"](), solver=JH, **W.HODLR_MESH_KW)
    gj.compute(x, yerr)
    _jax_pivots(gj, "piv_hodlr_mesh", inputs)
    n_sp = len(W.sparse_mesh_problem()[0])
    seed = 42
    for name, s in (("sparse_probes", seed), ("sparse_grad_probes",
                                               seed + 1)):
        inputs[name] = np.array(jax.random.rademacher(
            jax.random.PRNGKey(s), (W.SPARSE_MESH_KW["num_probes"], n_sp),
            dtype=jnp.float64))
    tmp = os.path.join(workdir, "inputs.tmp.npz")
    np.savez(tmp, **inputs)
    os.replace(tmp, os.path.join(workdir, "inputs.npz"))

    # the JAX references, while the ranks run
    ref["hodlr_mesh"] = {
        "ll": gj.log_likelihood(y), "grad": gj.grad_log_likelihood(y),
        "predict": gj.predict(y, t, return_var=True)}
    ref["dense"] = _jax_predict(jgt.GP(K["dense"]()), W.dense_problem())
    for name in ("hodlr", "hodlr_sym"):
        x, y_h, _, t_h = W.hodlr_predict_problem()
        ref[name] = gp_h[name].predict(y_h, t_h, return_var=True)
    ref["sparse"] = _jax_predict(
        jgt.GP(K["sparse_predict"](), solver=jgt.SparseSolver),
        W.sparse_predict_problem())
    ref["sparse_cg"] = _jax_predict(
        jgt.GP(K["sparse_predict"](), solver=jgt.SparseSolver, direct=False),
        W.sparse_predict_problem())
    ref["hmatrix"] = _jax_predict(
        jgt.GP(K["hmatrix"](), solver=jgt.HMatrixSolver, min_size=64,
               rank=16, precond_rank=64), W.hmatrix_problem())
    xs, ys, yerrs = W.sparse_mesh_problem()
    gs = jgt.GP(K["sparse_mesh"](), solver=jgt.SparseSolver,
                **W.SPARSE_MESH_KW)
    gs.compute(xs, yerrs)
    ref["sparse_mesh"] = {"ll": gs.log_likelihood(ys),
                          "grad": gs.grad_log_likelihood(ys),
                          "logdet": gs.solver.log_determinant}
    K_dense = np.asarray(K["sparse_mesh"]().get_value(xs))
    ref["sparse_mesh"]["dense_logdet"] = np.linalg.slogdet(
        K_dense + np.diag(yerrs ** 2))[1]
    # the JAX package's fused sparse likelihood on the same probes
    lp = jax.jit(jax.value_and_grad(gs.log_prob_fn(xs, ys, yerrs)))
    thetas = gs.get_parameter_vector()[None, :] + np.asarray(
        W.SPARSE_LOG_PROB_SHIFTS)
    vg = [lp(jnp.asarray(th)) for th in thetas]
    ref["sparse_mesh_log_prob"] = {
        "value": np.array([float(v) for v, _ in vg]),
        "grad": np.stack([np.asarray(g) for _, g in vg])}
    # the JAX package's unsharded symmetric solver on the mesh scenario;
    # its exact gradient is the fused likelihood's, through the same SMW
    # cascade as without sym (hence ``gj``'s)
    x, y, yerr, t = W.hodlr_mesh_problem()
    R, Y = W.sym_rows()
    g = jgt.GP(K["hodlr_mesh"](), solver=JH, sym=True,
               grad_mode="hutchinson", **W.HODLR_MESH_KW)
    g.compute(x, yerr)
    mu, var = g.predict(y, t, return_var=True)
    np.random.seed(W.SAMPLE_SEED)
    ref["hodlr_mesh_sym"] = {
        "ll": g.log_likelihood(y), "logdet": g.solver.log_determinant,
        "grad": ref["hodlr_mesh"]["grad"],
        "hutchinson": g.grad_log_likelihood(y), "mu": mu,
        "var": var, "sqrt": g.solver.apply_sqrt(R),
        "winv": g.solver.apply_inverse_sym_W(Y),
        "winvt": g.solver.apply_inverse_sym_W_transpose(Y),
        "sample": g.sample()}

    ranks = {}
    for world, ps in procs.items():
        logs = []
        for p in ps:
            try:
                logs.append(p.communicate(timeout=SPAWN_TIMEOUT)[0])
            except subprocess.TimeoutExpired:
                for q in ps:
                    q.kill()
                raise
        for rank, (p, log) in enumerate(zip(ps, logs)):
            assert p.returncode == 0, "rank %d of %d failed:\n%s" % (
                rank, world, log)
        ranks[world] = []
        for rank in range(world):
            with open(os.path.join(workdir, "out_%d_%d.pkl"
                                   % (world, rank)), "rb") as f:
                ranks[world].append(pickle.load(f))
    thread.join(SPAWN_TIMEOUT)
    return {"ranks": ranks, "ref": ref, "dryrun": dryrun.get("out")}


def _result(groups, world, name, rank=0):
    res = groups["ranks"][world][rank][name]
    assert "error" not in res, res.get("error")
    return res


@pytest.mark.parametrize("world", WORLDS)
def test_port_sharded_nuts_gaussian(groups, world):
    """``sharded_sample_nuts`` samples N(0, I) (the JAX test's bounds)."""
    r = _result(groups, world, "nuts_gaussian")
    assert r["shape"] == (300, 2 * world, 3)
    assert np.allclose(r["mean"], 0.0, atol=0.12)
    assert np.allclose(r["std"], 1.0, atol=0.15)


@pytest.mark.parametrize("world", WORLDS)
def test_port_sharded_transitions_match_unsharded(groups, world):
    """NUTS and HMC transitions with fixed tuning: the sharded draws are
    the unsharded run's (each chain draws the same numbers and the trees
    end together), to rounding."""
    r = _result(groups, world, "nuts_transitions")
    for name in ("nuts", "hmc"):
        ref, sh = r[name]["samples"]
        assert sh.shape == ref.shape == (60, 4 * world, 4)
        np.testing.assert_allclose(sh, ref, rtol=0, atol=1e-12)
        np.testing.assert_allclose(*r[name]["accept"], rtol=0, atol=1e-12)
        assert r[name]["evals"][0] == r[name]["evals"][1]


@pytest.mark.parametrize("world", WORLDS)
def test_port_dense_mass_nuts_sharded(groups, world):
    """Dense-mass NUTS with warmup, sharded, against the unsharded run at
    the JAX test's bounds. The unsharded run evaluates its chains two at a
    time, as each rank does: a chain's values round by the batch they are
    evaluated in, and the step-size adaptation amplifies 1-ulp differences
    into different draws (8 chains in one batch against 4 ranks of 2 on
    this CPU: 1e-13 after 10 warmup steps, O(1) after 150)."""
    r = _result(groups, world, "dense_mass_nuts")
    np.testing.assert_allclose(*r["samples"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(*r["step_size"], rtol=1e-9)
    np.testing.assert_allclose(*r["sigma"], rtol=0, atol=1e-12)
    assert r["evals"][0] == r["evals"][1]


@pytest.mark.parametrize("world", WORLDS)
def test_port_sharded_ensemble_matches_unsharded(groups, world):
    r = _result(groups, world, "ensemble")
    for key in ("chain", "logp", "accept"):
        ref, sh = r[key]
        assert ref.shape == sh.shape
        np.testing.assert_allclose(sh, ref, rtol=0, atol=1e-12)


@pytest.mark.parametrize("world", WORLDS)
def test_port_shard_chains_placement(groups, world):
    for rank in range(world):
        r = _result(groups, world, "shard_chains", rank)
        rows = len(r["arr"]) // world
        np.testing.assert_array_equal(
            r["local"], r["arr"][rank * rows:(rank + 1) * rows])
        np.testing.assert_array_equal(r["gathered"], r["arr"])
        assert r["device"] == "cpu" and r["rank"] == rank


@pytest.mark.parametrize("solver", ["dense", "hodlr", "hodlr_sym", "sparse",
                                    "sparse_cg", "hmatrix"])
@pytest.mark.parametrize("world", WORLDS)
def test_port_sharded_predict(groups, world, solver):
    """``sharded_predict`` through each solver's device-side solve against
    the JAX ``gp.predict`` (the JAX tests' bounds: 1e-8 dense, 1e-6
    otherwise; the HODLR solvers on the JAX package's pivots) and against
    the port's own ``gp.predict`` on one rank (1e-10)."""
    r = _result(groups, world, "predict")[solver]
    mu_ref, var_ref = groups["ref"][solver]
    tol = 1e-8 if solver == "dense" else 1e-6
    assert r["mu"].shape == mu_ref.shape == (101,)
    np.testing.assert_allclose(r["mu"], mu_ref, rtol=0, atol=tol)
    np.testing.assert_allclose(r["var"], var_ref, rtol=0, atol=tol)
    np.testing.assert_allclose(r["mu"], r["mu_1"], rtol=0, atol=1e-10)
    np.testing.assert_allclose(r["var"], r["var_1"], rtol=0, atol=1e-10)


@pytest.mark.parametrize("world", WORLDS)
def test_port_hodlr_mesh_matches_reference(groups, world):
    """``HODLRSolver(mesh=)`` on n = 2000 (16 leaves), on the JAX package's
    pivots: against the port's unsharded GP at the JAX test's bounds
    (likelihood 1e-6; gradient and prediction with its ``np.allclose``
    calls), and against the JAX unsharded GP at the distance the
    unsharded port keeps from it on this problem (likelihood 1.4e-6 = 2.7e-9
    relative, mean 2.8e-8: the ridge-regime skeletons' rounding, see
    ``tests/test_torch_hodlr.py``): relative 1e-8, the gradient's
    ``np.allclose`` and 1e-7."""
    r = _result(groups, world, "hodlr_mesh")
    sh, one = r["jax_pivots"], r["jax_pivots_1"]
    ref = groups["ref"]["hodlr_mesh"]
    assert sh["sharded"] and sh["leaves"] == 16 // world
    assert not one["sharded"] and one["leaves"] == 16
    assert abs(sh["ll"] - one["ll"]) < 1e-6
    assert np.allclose(sh["grad"], one["grad"], atol=1e-6)
    assert np.allclose(sh["mu"], one["mu"], atol=1e-8)
    assert np.allclose(sh["var"], one["var"], atol=1e-8)
    mu, var = ref["predict"]
    assert abs(sh["ll"] - ref["ll"]) < 1e-8 * abs(ref["ll"])
    assert np.allclose(sh["grad"], ref["grad"], atol=1e-6)
    np.testing.assert_allclose(sh["mu"], mu, rtol=0, atol=1e-7)
    np.testing.assert_allclose(sh["var"], var, rtol=0, atol=1e-7)


@pytest.mark.parametrize("world", WORLDS)
def test_port_hodlr_mesh_own_pivots(groups, world):
    """The port's own ACA pivots (rank 0's, adopted by every rank) give
    the unsharded port's likelihood, gradient and prediction."""
    r = _result(groups, world, "hodlr_mesh")
    one, sh = r["aca_1"], r["aca"]
    assert sh["sharded"] and not one["sharded"]
    assert abs(sh["ll"] - one["ll"]) < 1e-9 * abs(one["ll"])
    assert np.allclose(sh["grad"], one["grad"], atol=1e-6)
    np.testing.assert_allclose(sh["mu"], one["mu"], rtol=0, atol=1e-10)
    np.testing.assert_allclose(sh["var"], one["var"], rtol=0, atol=1e-10)


@pytest.mark.parametrize("world", WORLDS)
def test_port_hodlr_mesh_hutchinson_and_log_prob(groups, world):
    """Under ``mesh=``: the Hutchinson gradient (the same probes) and
    ``log_prob_fn`` under the samplers' ``vmap(grad_and_value)`` equal the
    unsharded solver's."""
    r = _result(groups, world, "hodlr_mesh")
    np.testing.assert_allclose(r["hutchinson"], r["hutchinson_1"],
                               rtol=1e-8, atol=1e-10)
    (g_s, v_s), (g_1, v_1) = (r["log_prob_vmap"]["sharded"],
                              r["log_prob_vmap"]["one"])
    assert g_s.shape == (3, 2) and np.all(np.isfinite(v_s))
    np.testing.assert_allclose(v_s, v_1, rtol=1e-10)
    np.testing.assert_allclose(g_s, g_1, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("world", WORLDS)
def test_port_hodlr_mesh_functions(groups, world):
    """The functional Hutchinson likelihood and gradient (one refinement
    step, with its trace correction) and the refined solve on a sharded
    structure equal the unsharded ones on the same probes."""
    r = _result(groups, world, "hodlr_mesh")
    sh, one = r["functions"], r["functions_1"]
    assert abs(sh["ll"] - one["ll"]) < 1e-9 * abs(one["ll"])
    np.testing.assert_allclose(sh["grad"], one["grad"], rtol=1e-8,
                               atol=1e-8)
    assert sh["solve"].shape == one["solve"].shape
    np.testing.assert_allclose(sh["solve"], one["solve"], rtol=0,
                               atol=1e-9 * np.abs(one["solve"]).max())


@pytest.mark.parametrize("world", WORLDS)
def test_port_hodlr_mesh_refusals(groups, world):
    """A leaf count that does not split over the ranks warns and runs
    unsharded."""
    r = _result(groups, world, "hodlr_mesh")
    assert r["odd"]["warned"] and not r["odd"]["sharded"]
    assert np.isfinite(r["odd"]["ll"])


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b))
                 / np.linalg.norm(np.asarray(b)))


@pytest.mark.parametrize("world", WORLDS)
def test_port_hodlr_mesh_sym_matches_reference(groups, world):
    """``HODLRSolver(mesh=, sym=True)`` on n = 2000 (16 leaves), on the JAX
    package's pivots, against the JAX package's unsharded ``sym=True``
    solver at the bounds of ``test_port_hodlr_mesh_matches_reference``
    (likelihood and log-determinant 1e-8 relative, gradients with its
    ``np.allclose``, prediction 1e-7) and the products ``W^T`` (rows of
    ``apply_sqrt``), ``W^{-1}`` and ``W^{-T}`` to 1e-7 relative (the
    unsharded port keeps 5e-9 of the JAX factors on its own rig,
    ``tests/test_torch_hodlr_sym.py``); the symmetric Hutchinson gradient
    on the same numpy probes; ``GP.sample`` after the same
    ``np.random.seed`` against the JAX draw and the one-rank port draw."""
    r = _result(groups, world, "hodlr_mesh_sym")
    sh, one = r["sharded"], r["one"]
    ref = groups["ref"]["hodlr_mesh_sym"]
    assert sh["sharded"] and sh["leaves"] == 16 // world
    assert not one["sharded"] and one["leaves"] == 16
    for res in (sh, one):
        assert abs(res["ll"] - ref["ll"]) < 1e-8 * abs(ref["ll"])
        assert abs(res["logdet"] - ref["logdet"]) < 1e-8 * abs(ref["logdet"])
        assert np.allclose(res["grad"], ref["grad"], atol=1e-6)
        assert np.allclose(res["hutchinson"], ref["hutchinson"], atol=1e-6)
        np.testing.assert_allclose(res["mu"], ref["mu"], rtol=0, atol=1e-7)
        np.testing.assert_allclose(res["var"], ref["var"], rtol=0, atol=1e-7)
        for key in ("sqrt", "winv", "winvt", "sample"):
            assert res[key].shape == ref[key].shape
            assert _rel(res[key], ref[key]) < 1e-7, key
    assert abs(sh["ll"] - one["ll"]) < 1e-6
    assert np.allclose(sh["grad"], one["grad"], atol=1e-6)
    np.testing.assert_allclose(sh["hutchinson"], one["hutchinson"],
                               rtol=1e-8, atol=1e-10)
    for key in ("sqrt", "winv", "winvt", "sample"):
        assert _rel(sh[key], one[key]) < 1e-12, key


@pytest.mark.parametrize("world", WORLDS)
def test_port_hodlr_mesh_sym_reverse_mode(groups, world):
    """Reverse mode and ``vmap`` through the sharded symmetric
    factorization (a coarse level reaches theta through ``gather_rows``)
    equal the unsharded factorization's, at rank 8 (where every core
    eigenvalue is simple); the gradients at the rounding the near-equal
    eigenvalues leave (the unsharded ``vmap`` differs from its unbatched
    call by 1e-6 relative on a CPU)."""
    r = _result(groups, world, "hodlr_mesh_sym")
    sh, one = r["sharded"]["functions"], r["one"]["functions"]
    assert abs(sh["value"] - one["value"]) < 1e-10 * abs(one["value"])
    np.testing.assert_allclose(sh["vmap_value"], one["vmap_value"],
                               rtol=1e-10)
    assert np.all(np.isfinite(sh["grad"])) and np.all(np.isfinite(
        sh["vmap_grad"]))
    assert np.allclose(sh["grad"], one["grad"], atol=1e-6)
    assert np.allclose(sh["vmap_grad"], one["vmap_grad"], atol=1e-6)
    assert np.allclose(sh["vmap_grad"][0], sh["grad"], atol=1e-6)


@pytest.mark.parametrize("world", WORLDS)
def test_port_gather_rows_adjoints(groups, world):
    """``gather_rows``: the gradient in each rank's block, the ``jvp`` and
    the ``vmap`` of a function of the gathered rows equal the whole
    array's."""
    for rank in range(world):
        r = _result(groups, world, "gather_rows", rank)
        for key in ("grad", "jvp", "vmap"):
            np.testing.assert_allclose(*r[key], rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("world", WORLDS)
def test_port_sparse_mesh_matches_reference(groups, world):
    """``SparseSolver(mesh=)`` (n = 301: padded rows on every mesh) on the
    JAX package's probes against its unsharded solver, within the JAX
    package's own bounds (``tests/test_sparse.py``: SLQ log-determinant 3%
    of the dense one, gradient ``rtol=0.15, atol=0.5``) and, with the
    same probes, to 1e-7 relative (the 40 Lanczos steps of SLQ amplify
    the reordered sums of 4 ranks to 1.2e-8 of the likelihood; the
    unsharded port is within 1e-8)."""
    r = _result(groups, world, "sparse_mesh")
    ref = groups["ref"]["sparse_mesh"]
    sh, one = r["sharded"], r["one"]
    assert sh["sharded"] and not one["sharded"]
    assert sh["rows"] == -(-301 // world)
    for res in (sh, one):
        assert abs(res["ll"] - ref["ll"]) < 1e-7 * abs(ref["ll"])
        np.testing.assert_allclose(res["grad"], ref["grad"], rtol=1e-7,
                                   atol=1e-10)
        assert abs(res["logdet"] - ref["dense_logdet"]) < 0.03 * abs(
            ref["dense_logdet"])
        assert np.allclose(res["grad"], ref["grad"], rtol=0.15, atol=0.5)
    assert abs(one["ll"] - ref["ll"]) < 1e-8 * abs(ref["ll"])
    np.testing.assert_allclose(sh["sample"], one["sample"], rtol=0,
                               atol=1e-10)


@pytest.mark.parametrize("world", WORLDS)
def test_port_sparse_mesh_refusals(groups, world):
    """The direct (banded) path refuses a mesh, as in the JAX package."""
    r = _result(groups, world, "sparse_mesh")
    assert r["refusals"] == {"direct": True}


@pytest.mark.parametrize("world", WORLDS)
def test_port_sparse_mesh_log_prob(groups, world):
    """``GP.log_prob_fn`` through ``SparseSolver(mesh=).loglike_fn`` (CG
    and SLQ with their adjoints, rows split) on the JAX package's probes:
    value and gradient against the JAX package's ``log_prob_fn`` at the
    computed parameters and a step away, to the bounds of
    ``test_port_sparse_mesh_matches_reference`` (1e-7 relative; gradient
    ``rtol=1e-7``); ``vmap`` over the 2 chains against the unbatched
    calls, and the sharded results against one rank's."""
    r = _result(groups, world, "sparse_mesh_log_prob")
    ref = groups["ref"]["sparse_mesh_log_prob"]
    sh, one = r["sharded"], r["one"]
    assert sh["sharded"] and not one["sharded"]
    for res in (sh, one):
        np.testing.assert_allclose(res["value"], ref["value"], rtol=1e-7)
        np.testing.assert_allclose(res["grad"], ref["grad"], rtol=1e-7,
                                   atol=1e-10)
    np.testing.assert_allclose(sh["vmap_value"], sh["value"], rtol=1e-12)
    np.testing.assert_allclose(sh["vmap_grad"], sh["grad"], rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(sh["value"], one["value"], rtol=1e-7)
    np.testing.assert_allclose(sh["grad"], one["grad"], rtol=1e-8,
                               atol=1e-10)


@pytest.mark.parametrize("world", WORLDS)
def test_port_ranks_agree(groups, world):
    """SPMD determinism: every rank returns the same whole results."""
    def flat(v):
        if isinstance(v, dict):
            return [x for k in sorted(v) for x in flat(v[k])]
        if isinstance(v, (tuple, list)):
            return [x for e in v for x in flat(e)]
        return [v]

    skip = {"shard_chains", "gather_rows"}     # per-rank by design
    first = groups["ranks"][world][0]
    for other in groups["ranks"][world][1:]:
        for name in first:
            if name in skip:
                continue
            for a, b in zip(flat(first[name]), flat(other[name])):
                if isinstance(a, np.ndarray):
                    np.testing.assert_array_equal(a, b)
                else:
                    assert a == b or (a != a and b != b), name


def test_port_dryrun_multichip_device_default():
    """``dryrun_multichip`` runs on the card unless asked for the CPU, and
    refuses other devices before it spawns a rank."""
    import inspect

    from george_tpu_torch.entry import dryrun_multichip

    params = inspect.signature(dryrun_multichip).parameters
    assert params["device"].default == "cuda"
    with pytest.raises(ValueError, match="runs on 'cuda' or 'cpu'"):
        dryrun_multichip(2, device="meta")


def test_port_dryrun_multichip_two_ranks(groups):
    """``entry.dryrun_multichip(2, device="cpu")`` (run beside the
    groups): the sharded
    ensemble sweep equals the unsharded one, and NUTS and the row-sharded
    HODLR GP run."""
    out = groups["dryrun"]
    if isinstance(out, Exception):
        raise out
    assert out["world"] == 2 and out["hodlr_sharded"]
    assert out["ensemble_vs_unsharded"] == 0.0
    assert np.isfinite(out["hodlr_ll"])


def test_port_initialize_and_single_process_mesh(monkeypatch):
    """``initialize`` does nothing without a rendezvous; a process that has
    joined no group gets a one-rank mesh, on which ``sharded_predict``
    is ``gp.predict``."""
    import torch.distributed as dist

    monkeypatch.delenv("MASTER_ADDR", raising=False)
    assert parallel.initialize() is False
    assert not dist.is_initialized()
    try:
        mesh = parallel.chain_mesh(device_type="cpu")
        assert mesh.size() == 1 and mesh.mesh_dim_names == ("chains",)
        x, y, yerr, t = W.dense_problem()
        gp = tgt.GP(1.0 * tgt.kernels.ExpSquaredKernel(1.0), device="cpu")
        gp.compute(x, yerr)
        mu, var = parallel.sharded_predict(mesh, gp, y, t)
        mu1, var1 = gp.predict(y, t, return_var=True)
        np.testing.assert_allclose(mu, mu1, rtol=0, atol=1e-12)
        np.testing.assert_allclose(var, var1, rtol=0, atol=1e-12)
        arr = np.arange(12.0).reshape(4, 3)
        np.testing.assert_array_equal(parallel.shard_chains(mesh, arr), arr)
        assert parallel.initialize(init_method="tcp://127.0.0.1:1") is False
    finally:
        dist.destroy_process_group()
