# -*- coding: utf-8 -*-
"""The port's auxiliary surface against the JAX package, in float64 on the
CPU: ``diagnostics`` (timer registry, verbose spans, trace), ``checkpoint``
(round trips, and ``.npz`` files read across the two packages), the HODLR
factorization self-check, ``debug=True`` and the GP's debug gradient
check (after ``tests/test_aux.py`` and ``tests/test_hodlr.py``)."""

import json
import sys
import warnings

import numpy as np
import pytest
import torch

import george_tpu as jgt
from george_tpu import checkpoint as jck
from george_tpu import kernels as jk
import george_tpu_torch as tgt
from george_tpu_torch import checkpoint, diagnostics
from george_tpu_torch import kernels as tk
from george_tpu_torch.solvers import hodlr as TH

torch.set_num_threads(2)

DEV = "cpu"   # the port's entry points default to the card


def _data(n, seed=0, span=20.0):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0, span, n))[:, None]
    yerr = 0.3 * np.ones(n)
    y = np.sin(x[:, 0]) + 0.3 * rng.standard_normal(n)
    return x, y, yerr


# ---------------------------------------------------------------------------
# diagnostics
# ---------------------------------------------------------------------------

def test_port_timer_registry():
    diagnostics.reset()
    with diagnostics.timer("unit.test") as tm:
        out = tm.sync({"a": torch.ones(8) * 2, "b": [torch.zeros(2)]})
    assert torch.equal(out["a"], torch.full((8,), 2.0))
    with diagnostics.timer("unit.test"):
        pass
    rep = diagnostics.report()
    assert rep["unit.test"]["count"] == 2
    assert rep["unit.test"]["total_s"] >= rep["unit.test"]["best_s"]
    assert rep["unit.test"]["mean_s"] == pytest.approx(
        rep["unit.test"]["total_s"] / 2)
    diagnostics.reset()
    assert diagnostics.report() == {}


@pytest.mark.parametrize("solver", ["hodlr", "basic"])
def test_port_verbose_solvers_register_spans(capsys, solver):
    diagnostics.reset()
    x, _, yerr = _data(200, span=10.0)
    k = 1.0 * tk.ExpSquaredKernel(1.0)
    if solver == "hodlr":
        s = tgt.HODLRSolver(k, min_size=64, rank=16, verbose=True,
                            device=DEV)
    else:
        s = tgt.BasicSolver(k, verbose=True, device=DEV)
    s.compute(x, yerr)
    name = solver + ".compute"
    assert diagnostics.report()[name]["count"] == 1
    assert "[george-tpu] %s:" % name in capsys.readouterr().out
    # quiet solvers register the span without printing it
    q = type(s)(k, device=DEV)
    q.compute(x, yerr)
    assert diagnostics.report()[name]["count"] == 2
    assert name not in capsys.readouterr().out


def test_port_trace_and_annotate(tmp_path):
    with diagnostics.trace(str(tmp_path)) as log_dir:
        with diagnostics.annotate("george.unit"):
            torch.ones(16).sum()
    assert log_dir == str(tmp_path)
    text = (tmp_path / "trace.json").read_text()
    assert "george.unit" in text


def _user_annotations(path):
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [e["name"] for e in events if e.get("cat") == "user_annotation"]


def test_port_annotate_is_one_check_when_no_profiler_runs(tmp_path,
                                                          monkeypatch):
    """Off: no ``record_function`` at all, a shared null context; on: one
    ``user_annotation`` event a region, ``timer``'s spans included."""
    calls = []
    record = torch.profiler.record_function

    def counted(name):
        calls.append(name)
        return record(name)

    monkeypatch.setattr(torch.profiler, "record_function", counted)
    assert not diagnostics.profiling()
    with diagnostics.annotate("george.off") as region:
        assert region is None
    assert diagnostics.annotate("a") is diagnostics.annotate("b")
    with diagnostics.timer("george.timer.off"):
        pass
    assert calls == []
    with diagnostics.trace(str(tmp_path)):
        assert diagnostics.profiling()
        with diagnostics.annotate("george.on"):
            torch.ones(4).sum()
        with diagnostics.timer("george.timer.on"):
            torch.ones(4).sum()
    assert calls == ["george.on", "george.timer.on"]
    names = _user_annotations(str(tmp_path / "trace.json"))
    assert names.count("george.on") == 1
    assert names.count("george.timer.on") == 1
    assert "george.off" not in names and "george.timer.off" not in names
    assert diagnostics.report()["george.timer.on"]["count"] == 1


def test_port_backward_mark_spans_the_reverse_pass(tmp_path):
    """The marks are the identity (the input itself while no profiler
    runs); under a trace the reverse pass between them is one span, once
    for a ``vmap`` batch too, and none is left open."""
    def f(t):
        t = diagnostics.backward_mark(t)
        out = torch.sum(torch.sin(t) ** 2)
        return diagnostics.backward_mark(out, "unit.backward")

    t = torch.linspace(0.0, 1.0, 5, dtype=torch.float64)
    assert diagnostics.backward_mark(t) is t
    g0, v0 = torch.func.grad_and_value(f)(t)
    with diagnostics.trace(str(tmp_path)):
        g1, v1 = torch.func.grad_and_value(f)(t)
        g2, v2 = torch.func.vmap(torch.func.grad_and_value(f))(
            torch.stack([t, 2 * t]))
    assert torch.equal(g0, g1) and torch.equal(v0, v1)
    assert torch.equal(g2[0], g0) and torch.equal(v2[0], v0)
    names = _user_annotations(str(tmp_path / "trace.json"))
    assert names.count("unit.backward") == 2
    assert diagnostics._BACKWARD is None


# ---------------------------------------------------------------------------
# checkpoint
# ---------------------------------------------------------------------------

def _state():
    return {
        "walkers": np.random.default_rng(0).standard_normal((8, 3)),
        "log_probs": np.arange(8.0),
        "key": np.asarray([0, 7], dtype=np.uint32),
        "step": np.asarray(123, dtype=np.int64),
        "nested": {"a": np.ones(2), "b": [np.zeros(1), np.full(2, 5.0)]},
    }


def _assert_state(restored, state):
    assert sorted(restored) == sorted(state)
    for k in ("walkers", "log_probs", "key"):
        assert np.array_equal(restored[k], state[k])
        assert restored[k].dtype == state[k].dtype
    assert int(restored["step"]) == 123
    assert np.array_equal(restored["nested"]["a"], np.ones(2))
    assert isinstance(restored["nested"]["b"], list)
    assert np.array_equal(restored["nested"]["b"][1], np.full(2, 5.0))


def test_port_checkpoint_roundtrip(tmp_path):
    state = _state()
    state["tensor"] = torch.arange(4.0, dtype=torch.float32)
    path = checkpoint.save(str(tmp_path / "ck"), state)
    assert path.endswith(".npz")
    restored = checkpoint.load(str(tmp_path / "ck"))
    assert restored["tensor"].dtype == np.float32
    assert np.array_equal(restored.pop("tensor"), np.arange(4.0))
    state.pop("tensor")
    _assert_state(restored, state)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_files_cross_packages(tmp_path, monkeypatch, writer):
    """An ``.npz`` written by one package loads in the other, with the same
    keys (``__seq__`` markers included). The JAX package writes orbax when
    orbax is importable, so it is hidden from this test."""
    for name in ("orbax", "orbax.checkpoint"):
        monkeypatch.setitem(sys.modules, name, None)
    state = _state()
    save, load = ((jck.save, checkpoint.load) if writer == "jax"
                  else (checkpoint.save, jck.load))
    path = save(str(tmp_path / "ck"), state)
    assert path.endswith(".npz")
    _assert_state(load(path), state)
    with np.load(path) as data:
        assert sorted(data.files) == sorted(
            jck._flatten(jck._to_numpy(state)))


def test_port_sampler_state_roundtrip(tmp_path):
    """A sampler checkpoint with the port's keys: an int seed, a
    ``torch.Generator`` (its state, uint8) and the dense sampler's inverse
    mass dict, all restored bit for bit."""
    gen = torch.Generator().manual_seed(42)
    torch.rand(3, generator=gen)
    walkers = torch.randn(4, 2, dtype=torch.float64)
    lp = torch.randn(4, dtype=torch.float32)
    mass = {"sigma": torch.eye(2, dtype=torch.float64) * 2.0,
            "chol": torch.eye(2, dtype=torch.float64) * 2.0 ** 0.5}
    for key in (7, gen):
        state = checkpoint.sampler_state(
            walkers, lp, key, step=100, step_size=torch.full((4,), 0.3),
            inv_mass=mass, extras={"draws": [walkers, walkers + 1]})
        path = checkpoint.save(str(tmp_path / "s"), state)
        back = checkpoint.restore_sampler(path)
        assert np.array_equal(back["walkers"], walkers.numpy())
        assert back["log_probs"].dtype == np.float32
        assert np.array_equal(back["log_probs"], lp.numpy())
        assert int(back["step"]) == 100
        assert np.array_equal(back["step_size"], np.full(4, 0.3,
                                                         np.float32))
        assert np.array_equal(back["inv_mass"]["chol"],
                              mass["chol"].numpy())
        assert np.array_equal(back["extras"]["draws"][1],
                              walkers.numpy() + 1)
        if isinstance(key, int):
            assert int(back["key"]) == 7
        else:
            assert back["key"].dtype == np.uint8
            g2 = torch.Generator()
            g2.set_state(torch.from_numpy(back["key"]))
            assert torch.equal(torch.rand(5, generator=g2),
                               torch.rand(5, generator=gen))


# ---------------------------------------------------------------------------
# HODLR self-check and debug
# ---------------------------------------------------------------------------

def _self_check_warnings(gp, x):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        gp.compute(x, 0.25)
    return [w for w in caught if "self-check" in str(w.message)]


def test_port_hodlr_self_check_flags_nondecaying_kernels():
    """The SMW cascade breaks down on a non-decaying kernel: the self-check
    warns and reports the residual, as the JAX package's does; healthy
    kernels pass silently; the check is memoized per configuration and
    theta regime."""
    rng = np.random.default_rng(0)
    x = np.sort(rng.uniform(0, 10, 240))
    tgt.HODLRSolver._checked_configs.clear()
    gp = tgt.GP(0.2 * tk.PolynomialKernel(log_sigma2=0.0, order=3),
                solver=tgt.HODLRSolver, min_size=32, rank=24, device=DEV)
    assert _self_check_warnings(gp, x)
    assert gp.solver.factor_residual > 1e-6

    tgt.HODLRSolver._checked_configs.clear()
    gp2 = tgt.GP(1.2 * tk.ExpSquaredKernel(2.0), solver=tgt.HODLRSolver,
                 min_size=32, rank=24, device=DEV)
    assert not _self_check_warnings(gp2, x)
    assert gp2.solver.factor_residual < 1e-8
    gp2.compute(x, 0.25)
    assert gp2.solver.factor_residual is None
    # a new e-fold regime of theta re-triggers the check, once
    gp2.set_parameter_vector(gp2.get_parameter_vector() + 2.0)
    gp2.compute(x, 0.25)
    assert gp2.solver.factor_residual is not None
    gp2.compute(x, 0.25)
    assert gp2.solver.factor_residual is None


def test_port_hodlr_debug_reports_compression_error(capsys, monkeypatch):
    """``debug=True`` runs the check on every compute and measures the
    compression error against the exact kernel: on the JAX solver's pivots
    within 10% of the JAX package's value (measured 0.25%; the two ACA
    walks may break noise-level ties differently at this rank, which moves
    it by 11%); a rank too low for the data reports a visibly larger one."""
    x, y, yerr = _data(500)
    kw = dict(min_size=64, rank=32, debug=True)
    sj = jgt.HODLRSolver(1.2 * jk.ExpSquaredKernel(2.0), **kw)
    sj.compute(x, yerr)
    ref = sj._struct
    aca = TH.select_aca_pivots

    def jax_pivots(pair_fn, theta, xpad, valid, struct):
        for mine, theirs in zip(struct.levels, ref.levels):
            mine["row_piv"] = np.asarray(theirs["row_piv"])
            mine["col_piv"] = np.asarray(theirs["col_piv"])
        struct._build_flat()

    monkeypatch.setattr(TH, "select_aca_pivots", jax_pivots)
    s = tgt.HODLRSolver(1.2 * tk.ExpSquaredKernel(2.0), verbose=True,
                        device=DEV, **kw)
    s.compute(x, yerr)
    monkeypatch.setattr(TH, "select_aca_pivots", aca)
    assert s.factor_residual is not None and s.factor_residual < 1e-8
    assert s.compression_error is not None and s.compression_error < 1e-6
    out = capsys.readouterr().out
    assert "compression rel err" in out and "factorization residual" in out
    assert abs(s.compression_error - sj.compression_error) < (
        0.1 * sj.compression_error)
    # debug bypasses the memo
    s.compute(x, yerr)
    assert s.factor_residual is not None and s.compression_error is not None
    s_low = tgt.HODLRSolver(1.2 * tk.ExpSquaredKernel(2.0), min_size=64,
                            rank=2, debug=True, device=DEV)
    s_low.compute(x, yerr)
    assert s_low.compression_error > 10 * s.compression_error
    # without debug, a memoized recompute measures nothing
    s2 = tgt.HODLRSolver(1.2 * tk.ExpSquaredKernel(2.0), min_size=64,
                         rank=32, device=DEV)
    s2.compute(x, yerr)
    s2.compute(x, yerr)
    assert s2.factor_residual is None and s2.compression_error is None


def test_port_debug_gradient_check(capsys):
    """Under ``debug`` a matrix-free gradient is compared with the dense
    exact one (``GP.debug_gradient``), whose ``exact`` part matches the
    dense solver's gradient; above n = 20000 the comparison is skipped
    with a warning."""
    x, y, yerr = _data(300)

    def kern(pkg):
        return 0.9 * pkg.ExpSquaredKernel(1.5) + 0.2 * pkg.Matern32Kernel(
            0.5)

    kw = dict(min_size=64, rank=32, debug=True, grad_mode="hutchinson",
              num_probes=32)
    gt = tgt.GP(kern(tk), solver=tgt.HODLRSolver, white_noise=np.log(0.02),
                fit_white_noise=True, verbose=True, device=DEV, **kw)
    gt.compute(x, yerr)
    g = gt.grad_log_likelihood(y)
    rep = gt.debug_gradient
    assert np.array_equal(rep["estimated"], g)
    out = capsys.readouterr().out
    assert "grad_exact" in out and "grad_estimated" in out
    gd = tgt.GP(kern(tk), white_noise=np.log(0.02), fit_white_noise=True,
                device=DEV)
    gd.compute(x, yerr)
    np.testing.assert_allclose(rep["exact"], gd.grad_log_likelihood(y),
                               rtol=1e-8, atol=1e-10)
    assert rep["max_abs_delta"] == pytest.approx(
        np.max(np.abs(rep["exact"] - g)))

    gt._x = np.zeros((20001, 1))
    with pytest.warns(UserWarning, match="skipped at n=20001"):
        assert gt._debug_gradient_check(np.zeros(20001), g) is None
    assert gt.debug_gradient is None
