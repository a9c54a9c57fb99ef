# -*- coding: utf-8 -*-
"""The exact banded sparse deployment
(``gpbench/configs/sparse_banded_2e5.json``: bench_dia's compact-support GP
through ``SparseSolver``'s default direct path, the block-tridiagonal
Cholesky of ``solvers/banded.py``) on the CPU:

* the configuration is the iterative sparse cell's data, kernel, frozen
  parameter, white noise and dtype, with the direct path pinned;
* the cell runs through the benchmark's harness at n = 4000 on [0, 80)
  (bench_dia's density and x seed: b = 128, 32 blocks) and comes out
  correct against the float64 reference, untraced and traced; the harness
  runs here in float64, because at this size float32 alone reads
  ``grad_gap`` up to 1.8e-5 (the card's limit, set at n = 2e5, is
  1.2e-5), while the plumbing, spans, counter and faults are the same;
* the reference in float32 with TF32 products (the control) comes out
  not correct at that size;
* ``direct: true`` takes the banded path: the factors are kept and no CG
  iteration or step runs;
* the spans ``banded.factor``, ``banded.solve`` and ``banded.backward``
  open once per value + gradient and change no bit of the answer;
* ``block_steps`` grows by three steps a block every call, and the
  traced run reads ``reverse_steps``, the hand-written reverse sweep's
  steps, at one a block less one;
* a planted fault in the factorization comes out not correct.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import george_tpu_torch as tgt  # noqa: E402
from george_tpu_torch.ops import cg as tcg  # noqa: E402
from george_tpu_torch.solvers import banded  # noqa: E402
from george_tpu_torch.solvers import sparse as tsparse  # noqa: E402
from gpbench import harness, program  # noqa: E402

torch.set_num_threads(2)

WORKLOAD = "sparse_banded_2e5.fit"
SEED = 2 ** 33 + 29
SMALL = {"dataset": {"params": {"n": 4000, "high": 80.0}},
         "structure": {"block": 128, "blocks": 32},
         "reference": {"min_block": 256}}
# the harness runs in float64 here (see the module's docstring); the
# program's own tests below keep the configuration's float32
SMALL64 = dict(SMALL, dtype="float64")
TRAFFIC = {"warmup_calls": 1, "check_calls": 2, "trace_calls": 2}
SPANS = ("banded.factor", "banded.solve", "banded.backward")
METRICS = ("banded_factor_ms", "banded_solve_ms", "banded_backward_ms")


def _config(name):
    with open(os.path.join(ROOT, "gpbench", "configs", name + ".json")) as f:
        return json.load(f)


def test_config_is_the_sparse_cells_data_on_the_direct_path():
    banded_cfg, dia_cfg = _config("sparse_banded_2e5"), _config(
        "sparse_dia_2e5")
    for key in ("dataset", "kernel", "frozen", "white_noise", "dtype"):
        assert banded_cfg[key] == dia_cfg[key], key
    assert banded_cfg["solver"] == {"name": "SparseSolver",
                                    "options": {"direct": True}}
    assert banded_cfg["reference"]["method"] == "exact"
    st = banded_cfg["structure"]
    assert st["blocks"] == -(-banded_cfg["dataset"]["params"]["n"]
                             // st["block"])
    # the published x draw in every run, as in the iterative cell
    a = harness.Cell(WORKLOAD, SEED).data
    b = harness.Cell("sparse_dia_2e5.fit", SEED).data
    assert np.array_equal(a.x, b.x) and np.array_equal(a.y, b.y)


def _small_gp():
    cell = harness.Cell(WORKLOAD, SEED, overrides=SMALL)
    gp = program.build_gp(cell.config, "cpu")
    d = cell.data
    gp.compute(d.x, d.yerr)
    f = torch.func.grad_and_value(gp.log_prob_fn(d.x, d.y, d.yerr))
    return gp, f, torch.as_tensor(cell.theta0, dtype=gp.dtype)


@pytest.mark.parametrize("traced", [False, True])
def test_cell_on_cpu_matches_reference(traced):
    before = banded.block_steps
    result, checks = harness.run_cell(WORKLOAD, SEED, 0.5, traced,
                                      device="cpu", overrides=SMALL64,
                                      traffic=TRAFFIC)
    assert result["correct"] is True, result["checks"]
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert [c[0] for c in checks] == ["value_gap", "grad_gap"]
    assert banded.block_steps > before
    names = {m["name"] for m in harness.Cell(WORKLOAD, 1).metrics(
        "per_layer" if traced else "end_to_end")}
    assert set(result["metrics"]) <= names
    if traced:
        # the program's spans and counter are read on the CPU too; the
        # device's metrics are not
        for name in METRICS:
            assert result["metrics"][name]["value"] > 0, name
        assert result["metrics"]["banded_block_steps_per_call"][
            "value"] == 3 * 32
        assert result["metrics"]["banded_reverse_steps_per_call"][
            "value"] == 32 - 1
        assert set(result["metrics"]) == set(METRICS) | {
            "banded_block_steps_per_call", "banded_reverse_steps_per_call",
            "compute_s"}
    else:
        assert set(result["metrics"]) == names - {"peak_mem_gb"}


def test_direct_true_takes_the_banded_path():
    gp, f, th = _small_gp()
    solver = gp.solver
    assert solver.direct is True
    assert solver._band_factors is not None
    assert solver._block_size == 128
    assert solver._band_factors[0].shape == (32, 128, 128)
    assert solver.loglike_fn() is solver._direct_loglike
    iters, steps = tsparse.cg_iteration_count, tcg.cg_device_steps
    g, v = f(th)
    assert torch.isfinite(v) and torch.all(torch.isfinite(g))
    assert tsparse.cg_iteration_count == iters
    assert tcg.cg_device_steps == steps


def test_block_steps_three_a_block_every_call():
    gp, f, th = _small_gp()
    grew = []
    for k in range(3):
        before = banded.block_steps
        f(th + 0.01 * k)
        grew.append(banded.block_steps - before)
    nb = gp.solver._band_factors[0].shape[0]
    assert grew == [3 * nb] * 3


def test_spans_once_a_call_and_inert():
    from torch.profiler import ProfilerActivity, profile
    gp, f, th = _small_gp()
    g0, v0 = f(th)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        g1, v1 = f(th)
    got = [e.name for e in prof.events()]
    assert {n: got.count(n) for n in SPANS} == dict.fromkeys(SPANS, 1)
    assert torch.equal(g0, g1) and torch.equal(v0, v1)
    assert tgt.diagnostics._BACKWARD is None


def _zero_sub_block(monkeypatch):
    blocks = banded.band_blocks

    def broken(vals, offsets, diag, b):
        A, Bs = blocks(vals, offsets, diag, b)
        keep = torch.ones(Bs.shape[0], 1, 1, dtype=Bs.dtype)
        keep[Bs.shape[0] // 2] = 0.0
        return A, Bs * keep
    monkeypatch.setattr(banded, "band_blocks", broken)


def _drop_last_logdet(monkeypatch):
    cholesky = banded.banded_cholesky

    def broken(A, Bs):
        Ls, Cs, ld = cholesky(A, Bs)
        last = 2.0 * torch.sum(torch.log(torch.diagonal(Ls[-1])))
        return Ls, Cs, ld - last
    monkeypatch.setattr(banded, "banded_cholesky", broken)


@pytest.mark.parametrize("plant", [_zero_sub_block, _drop_last_logdet],
                         ids=["sub_block_zeroed", "last_logdet_dropped"])
def test_planted_fault_is_not_correct(monkeypatch, plant):
    plant(monkeypatch)
    result, checks = harness.run_cell(WORKLOAD, SEED, 0.5, False,
                                      device="cpu", overrides=SMALL64,
                                      traffic=TRAFFIC)
    assert result["correct"] is False
    assert any(v > lim for _, v, lim in checks), result["checks"]


def test_reference_tf32_control_is_not_correct():
    cell = harness.Cell(WORKLOAD, SEED, overrides=SMALL, traffic=TRAFFIC)
    inputs = cell.entry.draw(harness.stream(SEED, harness.STREAM_INPUTS),
                             cell, cell.traffic["check_calls"])
    expected = cell.entry.reference(cell.reference("cpu"), cell, inputs)
    got = cell.entry.reference(cell.reference("cpu", "tf32"), cell, inputs)
    gaps = cell.entry.gaps(got, expected)
    assert any(v > cell.limits[k] for k, v in gaps.items()), gaps
