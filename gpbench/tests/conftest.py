"""Shared pieces of the benchmark's CPU tests: small versions of each
configuration (the published recipes at fewer points, the same density
where the kernel's support depends on it) and the repository root on the
path."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

SMALL = {
    "hodlr_smooth_1e5": {"dataset": {"params": {"n": 2000, "high": 200.0}},
                         "structure": {"leaves": 16, "leaf_size": 125},
                         "reference": {"min_block": 64}},
    # a fifth of the density, in float64: at a few thousand points the
    # Lanczos of the program (one reorthogonalization) drifts from the
    # reference's exact-arithmetic quadrature by 1e-4 to 1e-2 in float32
    # (and at n = 600 in float64 too); at the configuration's n by 1e-5
    "sparse_dia_2e5": {"dataset": {"params": {"n": 1500, "high": 150.0}},
                       "dtype": "float64",
                       "reference": {"min_block": 128}},
}
# fewer calls a run
TRAFFIC = {"warmup_calls": 1, "check_calls": 2, "trace_calls": 2}


@pytest.fixture
def small():
    """Overrides that make a configuration small enough for the CPU."""
    return SMALL


@pytest.fixture
def cuda_device():
    """Skips the test where no card is present (decided in the test, not
    at import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the benchmark's card)")
    return "cuda"
