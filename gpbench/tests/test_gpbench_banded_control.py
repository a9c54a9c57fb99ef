"""The controls of ``sparse_banded_2e5.fit`` come out not correct under its
committed limits, at the configuration's own size on the card: the program
with torch's TF32 matrix products switched on (the block Cholesky's
``C_i C_i^T`` and the substitutions' products are TF32 then), and the
plain reference in float32 with every product's operands rounded to TF32.

    python3 -m pytest -p no:cacheprovider -m cuda \
        gpbench/tests/test_gpbench_banded_control.py
"""

import pytest

from gpbench import calibrate, harness

from .test_gpbench_control import failed_numbers, reference_tf32_fails

WORKLOAD = "sparse_banded_2e5.fit"
SEEDS = (101, 102, 103)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
def test_reference_tf32_control_on_card(cuda_device, seed):
    assert reference_tf32_fails(WORKLOAD, None, cuda_device, seed)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
def test_program_tf32_control_on_card(cuda_device, seed):
    cell = harness.Cell(WORKLOAD, seed)
    inputs = cell.entry.draw(harness.stream(seed, harness.STREAM_INPUTS),
                             cell, cell.traffic["check_calls"])
    got = calibrate.program_outputs(cell, inputs, cuda_device, tf32=True)
    expected = cell.entry.reference(cell.reference(cuda_device), cell,
                                    inputs)
    assert failed_numbers(cell, got, expected)
