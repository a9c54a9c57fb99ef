# -*- coding: utf-8 -*-
"""The refit-as-data-arrive HODLR deployment
(``gpbench/configs/hodlr_smooth_bo_1e5.json``: the smooth n = 1e5 model
recomputed on every batch of 8 new points, then 8 values + gradients) on
the CPU:

* the configuration is the smooth cell's model, data recipe, solver and
  reference, with ``growth``; ``max_n`` is the most points that keep the
  base's 512 leaves of 196;
* the cell runs through the benchmark's harness at n = 2,100 on [0, 210)
  (16 leaves of 132; batches of 4 up to 2,112, which all pad to one
  shape) and comes out correct against the float64 reference, untraced
  and traced;
* input ``j`` holds the base bit for bit plus ``j + 1`` batches, and no
  draw passes ``max_n``;
* a stale answer (the previous input's data) and a dropped batch come out
  not correct;
* two ``compute``s on one GP give, bit for bit, what a fresh GP gives on
  the second data, and the first solver is gone before the second factors;
* the spans ``hodlr.structure`` (with ``hodlr.aca_pivots`` inside),
  ``hodlr.compute``, ``hodlr.self_check`` and ``hodlr.graph_capture`` open
  once a call and change no bit of the answer;
* ``self_checks`` counts one a ``compute`` of a new n and none for a
  repeated one;
* a run whose device memory grows from call to call stops with
  ``DeviceMemoryGrowth``, where a few bytes a call pass.
"""

import gc
import json
import os
import sys
import weakref

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from george_tpu_torch.solvers import hodlr as TH  # noqa: E402
from gpbench import harness, program  # noqa: E402
from gpbench.entries import recompute  # noqa: E402

torch.set_num_threads(2)

WORKLOAD = "hodlr_smooth_bo_1e5.recompute"
SEED = 2 ** 33 + 37
SMALL = {"dataset": {"params": {"n": 2100, "high": 210.0}},
         "growth": {"batch": 4, "max_n": 2112},
         "structure": {"leaves": 16, "leaf_size": 132, "n_pad": 2112}}
TRAFFIC = {"evals": 2, "warmup_calls": 1, "check_calls": 2,
           "trace_calls": 2}
SPANS = ("hodlr.structure", "hodlr.aca_pivots", "hodlr.compute",
         "hodlr.self_check", "hodlr.graph_capture")
SPAN_METRICS = ("hodlr_structure_ms", "hodlr_pivots_ms",
                "hodlr_compute_factor_ms", "hodlr_self_check_ms")


def _config(name):
    with open(os.path.join(ROOT, "gpbench", "configs", name + ".json")) as f:
        return json.load(f)


def _cell():
    return harness.Cell(WORKLOAD, SEED, overrides=SMALL, traffic=TRAFFIC)


def _inputs(cell, count):
    return cell.entry.draw(harness.stream(SEED, harness.STREAM_INPUTS),
                           cell, count)


class _EagerGraph(object):
    """``_LoglikeGraph`` with its replay replaced by an eager value and
    gradient, on the CPU: the capture's plumbing without a card."""

    @staticmethod
    def holds(args):
        return True

    def __init__(self, f, key, args):
        self.key, self.f = key, f

    def run(self, args):
        grads, value = torch.func.grad_and_value(self.f, argnums=(0, 1, 2))(
            *args)
        return (value,) + tuple(grads)


def test_config_is_the_smooth_model_growing():
    bo, fit = _config("hodlr_smooth_bo_1e5"), _config("hodlr_smooth_1e5")
    for key in ("dataset", "kernel", "frozen", "white_noise", "solver",
                "dtype", "structure", "reference"):
        assert bo[key] == fit[key], key
    assert bo["reduced"] == []
    growth, st, opts = bo["growth"], bo["structure"], bo["solver"]["options"]
    assert growth["batch"] == 8
    # every n from the base to max_n pads to the base's tree; one more
    # point does not
    for n in (bo["dataset"]["params"]["n"], growth["max_n"]):
        s = TH.build_structure(n, min_size=opts["min_size"], rank=12)
        assert (s.n_pad, s.m, s.n_pad // s.m) == (
            st["n_pad"], st["leaf_size"], st["leaves"])
    assert TH.build_structure(growth["max_n"] + 1,
                              min_size=opts["min_size"]).n_pad != st["n_pad"]
    # the window's inputs fit under max_n at the benchmark's run length
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        seconds = json.load(f)["run_seconds"]
    with open(os.path.join(ROOT, "gpbench", "traffic",
                           "recompute.json")) as f:
        calls = int(np.ceil(json.load(f)["max_calls_per_s"] * seconds)) + 1
    assert bo["dataset"]["params"]["n"] + calls * growth["batch"] \
        <= growth["max_n"]


@pytest.mark.parametrize("traced", [False, True])
def test_cell_on_cpu_matches_reference(monkeypatch, traced):
    # a memo of its own, so that the traced pair reads the checks of its
    # own n: the first traced input has the warm-up's n, the second a new
    monkeypatch.setattr(TH.HODLRSolver, "_checked_configs", set())
    result, checks = harness.run_cell(WORKLOAD, SEED, 0.5, traced,
                                      device="cpu", overrides=SMALL,
                                      traffic=TRAFFIC)
    assert result["correct"] is True, result["checks"]
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert [c[0] for c in checks] == ["value_gap", "grad_gap"]
    names = {m["name"] for m in harness.Cell(WORKLOAD, 1).metrics(
        "per_layer" if traced else "end_to_end")}
    assert set(result["metrics"]) <= names
    if traced:
        m = {k: v["value"] for k, v in result["metrics"].items()}
        for name in SPAN_METRICS:
            assert m[name] > 0, name
        assert m["hodlr_self_checks_per_call"] == 0.5
        # the graph wants a card: on the CPU nothing is captured or
        # replayed, and the capture's span never opens
        assert m["hodlr_graph_captures_per_call"] == 0.0
        assert m["hodlr_graph_replays_per_call"] == 0.0
        assert "hodlr_graph_capture_ms" not in m
        assert set(m) == set(SPAN_METRICS) | {
            "compute_s", "hodlr_self_checks_per_call",
            "hodlr_graph_captures_per_call", "hodlr_graph_replays_per_call"}
    else:
        assert set(result["metrics"]) == names - {"peak_mem_gb"}


def test_inputs_hold_the_base_and_their_batches():
    cell = _cell()
    base, batch = cell.data, cell.config["growth"]["batch"]
    inputs = _inputs(cell, 3)
    prev = base.x
    for j, inp in enumerate(inputs):
        assert len(inp["x"]) == len(base.x) + (j + 1) * batch
        assert np.all(np.diff(inp["x"]) > 0)
        assert inp["theta"].shape == (2, len(cell.theta0))
        keep = np.isin(inp["x"], base.x)
        for key, want in (("x", base.x), ("y", base.y), ("yerr", base.yerr)):
            assert np.array_equal(inp[key][keep], want), key
        # the previous input's points, and one batch more, on the domain
        assert np.all(np.isin(prev, inp["x"]))
        new = inp["x"][~np.isin(inp["x"], prev)]
        assert len(new) == batch and np.all((new >= 0) & (new < 210.0))
        prev = inp["x"]
    # the same seed draws the same inputs
    again = _inputs(cell, 3)
    assert all(np.array_equal(a[k], b[k]) for a, b in zip(inputs, again)
               for k in ("x", "y", "yerr", "theta"))


def test_draw_refuses_to_pass_max_n():
    cell = _cell()
    _inputs(cell, 3)
    with pytest.raises(ValueError, match="max_n"):
        _inputs(cell, 4)


def _stale(inputs, cell):
    """The previous input's data at the last input's parameters."""
    return dict(inputs[-2], theta=inputs[-1]["theta"])


def _dropped_batch(inputs, cell):
    """The last input's data less its first batch."""
    first = inputs[0]["x"][~np.isin(inputs[0]["x"], cell.data.x)]
    keep = ~np.isin(inputs[-1]["x"], first)
    out = {k: inputs[-1][k][keep] for k in ("x", "y", "yerr")}
    return dict(out, theta=inputs[-1]["theta"])


@pytest.mark.parametrize("plant", [_stale, _dropped_batch],
                         ids=["stale", "dropped_batch"])
def test_planted_fault_is_not_correct(plant):
    cell = _cell()
    inputs = _inputs(cell, 3)
    gp = program.build_gp(cell.config, "cpu")
    call = cell.entry.make_call(gp, cell)
    planted = plant(inputs, cell)
    assert len(planted["x"]) == len(inputs[-1]["x"]) - 4
    expected = cell.entry.reference(cell.reference("cpu"), cell,
                                    inputs[-1:])
    got = cell.entry.gaps([call(inputs[-1])], expected)
    bad = cell.entry.gaps([call(planted)], expected)
    assert all(v <= cell.limits[k] for k, v in got.items()), got
    assert bad["value_gap"] > cell.limits["value_gap"], bad


def test_stale_run_is_not_correct(monkeypatch):
    """Every call answers on the base data, without its batches (the
    previous input's data, for the first input)."""
    make_call = recompute.make_call

    def stale(gp, cell):
        call = make_call(gp, cell)

        def broken(inp):
            keep = np.isin(inp["x"], cell.data.x)
            return call({"x": inp["x"][keep], "y": inp["y"][keep],
                         "yerr": inp["yerr"][keep], "theta": inp["theta"]})
        return broken

    monkeypatch.setattr(recompute, "make_call", stale)
    result, checks = harness.run_cell(WORKLOAD, SEED, 0.5, False,
                                      device="cpu", overrides=SMALL,
                                      traffic=TRAFFIC)
    assert result["correct"] is False
    assert any(v > lim for _, v, lim in checks), result["checks"]


def test_second_compute_is_a_fresh_gps_and_drops_the_first_solver(
        monkeypatch):
    cell = _cell()
    a, b = _inputs(cell, 2)
    theta = torch.as_tensor(b["theta"][0], dtype=torch.float32)

    def answer(gp, inp):
        gp.compute(inp["x"], inp["yerr"])
        f = torch.func.grad_and_value(gp.log_prob_fn(inp["x"], inp["y"],
                                                     inp["yerr"]))
        return f(theta)

    fresh = answer(program.build_gp(cell.config, "cpu"), b)
    gp = program.build_gp(cell.config, "cpu")
    answer(gp, a)
    # the fused gradient holds the solver too, the cached solve its answer
    gp.grad_log_likelihood(a["y"])
    gp.predict(a["y"], a["x"][:5])
    assert gp._fused is not None and gp._alpha is not None
    first = weakref.ref(gp.solver)
    alive = []
    compute = TH.HODLRSolver.compute

    def watched(self, *args, **kwargs):
        alive.append(first() is not None)
        return compute(self, *args, **kwargs)

    monkeypatch.setattr(TH.HODLRSolver, "compute", watched)
    gc.disable()
    try:
        again = answer(gp, b)
        assert alive == [False] and first() is None
    finally:
        gc.enable()
    for x, y in zip(again, fresh):
        assert torch.equal(x, y)


def test_spans_once_a_call_and_inert(monkeypatch):
    from torch.profiler import ProfilerActivity, profile
    monkeypatch.setattr(TH, "_LoglikeGraph", _EagerGraph)
    monkeypatch.setattr(TH.HODLRSolver, "_checked_configs", set())
    cell = _cell()
    a, b = _inputs(cell, 2)
    gp = program.build_gp(cell.config, "cpu")
    call = cell.entry.make_call(gp, cell)
    want = call(b)
    call(a)
    monkeypatch.setattr(TH.HODLRSolver, "_checked_configs", set())
    captures = TH.graph_captures
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = call(b)
    assert TH.graph_captures == captures + 1
    names = [e.name for e in prof.events()]
    assert {n: names.count(n) for n in SPANS} == dict.fromkeys(SPANS, 1)
    for x, y in zip(got, want):
        assert np.array_equal(x, y)


def test_self_checks_count_new_n_only(monkeypatch):
    monkeypatch.setattr(TH.HODLRSolver, "_checked_configs", set())
    cell = _cell()
    a, b = _inputs(cell, 2)
    counts = []
    for inp in (a, a, b, a):
        gp = program.build_gp(cell.config, "cpu")
        before = TH.self_checks
        gp.compute(inp["x"], inp["yerr"])
        counts.append(TH.self_checks - before)
    assert counts == [1, 0, 1, 0]


@pytest.mark.parametrize("step", [512, 64 << 20], ids=["batch", "leak"])
def test_memory_growth_stops_the_run(monkeypatch, step):
    """Device memory held after each call, as a card would read it: a
    batch's few bytes a call pass, a 64 MiB workspace kept a call stops
    the run."""
    held = []

    def allocated(device):
        held.append(10 ** 9 + step * len(held))
        return held[-1]

    monkeypatch.setattr(recompute, "_allocated", allocated)
    run = lambda: harness.run_cell(WORKLOAD, SEED, 0.5, False,  # noqa: E731
                                   device="cpu", overrides=SMALL,
                                   traffic=TRAFFIC)
    if step < recompute.GROWTH_SLACK:
        assert run()[0]["correct"] is True
        assert len(held) >= 2
    else:
        with pytest.raises(recompute.DeviceMemoryGrowth, match="grew"):
            run()
        assert len(held) == 2
