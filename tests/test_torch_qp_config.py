# -*- coding: utf-8 -*-
"""The quasi-periodic HODLR deployment (``gpbench/configs/hodlr_qp_1e5.json``:
bench.py's qp configuration, ``1.0 ExpSquared(20) x ExpSine2(1, ln 3.7)``
at rank 48) on the CPU:

* the plain reference's ``ExpSine2`` is the port's ``ExpSine2Kernel`` and
  george's formula, in value and in its gradient over ``gamma`` and
  ``log_period``; the whole spec gives the port's parameter names;
* the dataset recipe is bench.py's qp stream at seed 42, bit for bit;
* the cell runs through the benchmark's harness at n = 2000 on [0, 200)
  (16 leaves of 125, rank 48, float32 as on the card) and comes out
  correct against the float64 reference, untraced and traced;
* ``hodlr_factor``'s spans ``hodlr.skeletons`` and ``hodlr.cascade`` open
  once per value + gradient, for one chain and for two under ``vmap``,
  nest inside ``hodlr.factor`` so that the three self times add up to the
  outer span, and change no bit of the answer.
"""

import json
import math
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import george_tpu_torch as tgt  # noqa: E402
from george_tpu_torch import kernels as tk  # noqa: E402
from gpbench import harness, program, spans  # noqa: E402
from gpbench import trace as tr  # noqa: E402
from gpbench.reference import kernel as ref_kernel  # noqa: E402

torch.set_num_threads(2)

WORKLOAD = "hodlr_qp_1e5.fit"
SEED = 2 ** 33 + 17
SMALL = {"dataset": {"params": {"n": 2000, "high": 200.0}},
         "structure": {"leaves": 16, "leaf_size": 125},
         "reference": {"min_block": 64}}
TRAFFIC = {"warmup_calls": 1, "check_calls": 2, "trace_calls": 2}
SPANS = ("hodlr.factor", "hodlr.skeletons", "hodlr.cascade")


def _config():
    with open(os.path.join(ROOT, "gpbench", "configs",
                           "hodlr_qp_1e5.json")) as f:
        return json.load(f)


def _george_expsine2(gamma, log_period, d):
    return np.exp(-gamma * np.sin(np.pi * np.abs(d) / np.exp(log_period))
                  ** 2)


def test_reference_expsine2_matches_port_and_george():
    rng = np.random.default_rng(3)
    x1, x2 = rng.uniform(0, 20, 40), rng.uniform(0, 20, 30)
    d = x1[:, None] - x2[None, :]
    for gamma, log_period in ((1.0, math.log(3.7)), (2.3, -0.4)):
        node = ref_kernel.build({"ExpSine2": {"gamma": gamma,
                                              "log_period": log_period}})
        assert node.names == ["gamma", "log_period"]
        assert node.theta0 == [gamma, log_period]
        th = torch.tensor(node.theta0, dtype=torch.float64,
                          requires_grad=True)
        k = node.fn(th, torch.as_tensor(d))
        port = tk.ExpSine2Kernel(gamma=gamma, log_period=log_period)
        np.testing.assert_allclose(k.detach().numpy(),
                                   _george_expsine2(gamma, log_period, d),
                                   rtol=1e-13, atol=0)
        np.testing.assert_allclose(
            k.detach().numpy(),
            port.get_value(x1[:, None], x2[:, None], device="cpu"),
            rtol=1e-13, atol=0)
        # the gradient over (gamma, log_period), entry by entry
        grad = np.stack([np.stack([torch.autograd.grad(
            k[i, j], th, retain_graph=True)[0].numpy()
            for j in range(0, 30, 7)]) for i in range(0, 40, 9)])
        want = port.get_gradient(x1[::9, None], x2[::7, None], device="cpu")
        np.testing.assert_allclose(grad, want, rtol=1e-12, atol=1e-14)


def test_spec_gives_the_ports_parameters():
    spec = _config()["kernel"]
    node = ref_kernel.build(spec)
    port = program.build_kernel(spec)
    assert node.names == list(port.get_parameter_names())
    np.testing.assert_allclose(node.theta0, port.get_parameter_vector(),
                               rtol=1e-15, atol=0)
    rng = np.random.default_rng(5)
    x = np.sort(rng.uniform(0, 60, 50))
    with torch.no_grad():
        k = node.fn(torch.as_tensor(node.theta0, dtype=torch.float64),
                    torch.as_tensor(x[:, None] - x[None, :]))
    np.testing.assert_allclose(k.numpy(), port.get_value(x[:, None],
                                                         device="cpu"),
                               rtol=1e-13, atol=1e-300)


def _published_qp(n, seed=42):
    """bench.py's qp stream (``bench._dataset("qp", n)``), written out."""
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0, 1000.0, n))[:, None]
    y = (np.sin(2 * np.pi * x[:, 0] / 3.7) * np.cos(0.13 * x[:, 0])
         + 0.25 * rng.standard_normal(n))
    yerr2 = 0.0625 * np.ones(n)
    return x[:, 0], y, np.sqrt(yerr2)


def test_recipe_is_bench_qp_stream_at_published_seed():
    seed = _config()["dataset"]["published_seed"]
    cell = harness.Cell(WORKLOAD, seed)
    for got, want in zip((cell.data.x, cell.data.y, cell.data.yerr),
                         _published_qp(100_000, seed)):
        assert np.array_equal(got, want)
    assert cell.data.domain == (0.0, 1000.0)
    other = harness.Cell(WORKLOAD, SEED).data
    assert not np.array_equal(other.x, cell.data.x)


@pytest.mark.parametrize("traced", [False, True])
def test_cell_on_cpu_matches_reference(traced):
    result, checks = harness.run_cell(WORKLOAD, SEED, 0.5, traced,
                                      device="cpu", overrides=SMALL,
                                      traffic=TRAFFIC)
    assert result["correct"] is True, result["checks"]
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert [c[0] for c in checks] == ["value_gap", "grad_gap"]
    cell = harness.Cell(WORKLOAD, 1)
    kind = "per_layer" if traced else "end_to_end"
    names = {m["name"] for m in cell.metrics(kind)}
    assert set(result["metrics"]) <= names
    if traced:
        # the program's spans are read on the CPU too; the device's are not
        for name in ("hodlr_factor_ms", "hodlr_skeleton_ms",
                     "hodlr_cascade_ms", "hodlr_solve_ms",
                     "hodlr_backward_ms"):
            assert result["metrics"][name]["value"] > 0, name
    else:
        assert set(result["metrics"]) == names - {"peak_mem_gb"}


def _small_qp_gp(dtype=torch.float64):
    cell = harness.Cell(WORKLOAD, SEED, overrides=dict(
        SMALL, dtype=str(dtype).split(".")[-1]))
    gp = program.build_gp(cell.config, "cpu")
    d = cell.data
    gp.compute(d.x, d.yerr)
    return gp, d, cell.theta0


def _profiled(fn):
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(tr.WINDOW):
            out = fn()
    return out, prof


def test_factor_spans_once_a_call_nested_and_inert(tmp_path):
    gp, d, theta0 = _small_qp_gp()
    assert gp.solver._struct.levels[0]["c"] == 48
    f = torch.func.grad_and_value(gp.log_prob_fn(d.x, d.y, d.yerr))
    fv = torch.func.vmap(f)
    th = torch.as_tensor(theta0)
    ths = torch.stack([th, th + 0.01])
    off = f(th), fv(ths)
    for fn, arg, ref in ((f, th, off[0]), (fv, ths, off[1])):
        (g, v), prof = _profiled(lambda: fn(arg))
        got = [e.name for e in prof.events()]
        assert {n: got.count(n) for n in SPANS} == dict.fromkeys(SPANS, 1)
        assert torch.equal(g, ref[0]) and torch.equal(v, ref[1])
        path = str(tmp_path / "trace.json")
        prof.export_chrome_trace(path)
        t = tr.load(path)
        own = [tr.merged(t._clip(e) for e in t.host
                         if e["name"] == n and e.get("cat") == spans.SPAN_CAT)
               for n in SPANS]
        (fa, fb), = own[0]
        for (a, b), in own[1:]:
            assert fa <= a < b <= fb
        assert own[1][0][1] <= own[2][0][0]     # skeletons, then cascade
        selfs = [spans.self_seconds(t, n) for n in SPANS]
        assert all(s > 0 for s in selfs)
        assert sum(selfs) == pytest.approx(fb - fa, rel=1e-9, abs=1e-9)
    assert tgt.diagnostics._BACKWARD is None
