"""The controls come out not correct under the committed limits.

A control is the program's place taken by a computation in the nearest
precision below float32 with TF32 off: on the HODLR cells, the program
itself with torch's TF32 matrix products switched on (its own path); on
the sparse cell, whose path has no product that TF32 reaches, the plain
reference in float32 with every product's operands rounded to TF32. The
card's tests run at each configuration's own size (at a fifth of it, the
program with TF32 on still passes the `.fit` cell's limits); the CPU test
runs the sparse control at the harness tests' small size."""

import numpy as np
import pytest

from gpbench import calibrate, harness

from .conftest import SMALL

def failed_numbers(cell, outputs, expected):
    gaps = cell.entry.gaps(outputs, expected)
    return [k for k, v in gaps.items()
            if not (np.isfinite(v) and v <= cell.limits[k])]


def reference_tf32_fails(workload, overrides, device, seed):
    cell = harness.Cell(workload, seed, overrides=overrides)
    inputs = cell.entry.draw(harness.stream(seed, harness.STREAM_INPUTS),
                             cell, cell.traffic["check_calls"])
    expected = cell.entry.reference(cell.reference(device), cell, inputs)
    got = cell.entry.reference(cell.reference(device, "tf32"), cell, inputs)
    return failed_numbers(cell, got, expected)


def test_sparse_control_on_cpu():
    over = dict(SMALL["sparse_dia_2e5"], dtype="float32")
    assert reference_tf32_fails("sparse_dia_2e5.fit", over, "cpu", 5)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [101, 102, 103])
def test_sparse_control_on_card(cuda_device, seed):
    assert reference_tf32_fails("sparse_dia_2e5.fit", None, cuda_device,
                                seed)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["hodlr_smooth_1e5.fit",
                                      "hodlr_smooth_1e5.chains8",
                                      "hodlr_smooth_1e5.predict"])
def test_program_tf32_control_on_card(cuda_device, workload):
    for seed in (101, 102, 103):
        cell = harness.Cell(workload, seed)
        inputs = cell.entry.draw(harness.stream(seed, harness.STREAM_INPUTS),
                                 cell, cell.traffic["check_calls"])
        got = calibrate.program_outputs(cell, inputs, cuda_device, tf32=True)
        expected = cell.entry.reference(cell.reference(cuda_device), cell,
                                        inputs)
        assert failed_numbers(cell, got, expected), seed
