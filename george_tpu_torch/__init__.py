# -*- coding: utf-8 -*-
"""george-tpu-torch: the PyTorch and CUDA port of george-tpu.

The hierarchical (HODLR) marginal log-likelihood path of ``george_tpu``,
written in PyTorch for an NVIDIA H100: the kernel zoo generated from the
same YAML specs, the dense and trivial solvers, the HODLR solver in its
transposed cascade layout with exact-autograd and Hutchinson gradients,
and the ``GP`` object. The leaf Cholesky on a CUDA tensor is a CUDA kernel
written for ``sm_90a`` (``csrc/chol.cu``), built from source at first use.

The package imports ``torch``, ``numpy`` and ``scipy`` only — never JAX or
the JAX package — and takes an explicit ``device=`` and ``dtype=`` on the
solvers and the GP.

Float32 matrix products run in full FP32: TF32 keeps about three decimal
digits, which is the class of error (bf16 passes on the TPU's matrix unit
once put the N=1e5 log-likelihood 9e-2 off its anchor) that the skeleton
interpolation solves and the SMW cores cannot absorb. The setting is made
once, here.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

__version__ = "0.1.0"

from . import kernels  # noqa: E402,F401
from . import metrics  # noqa: E402,F401
from . import modeling  # noqa: E402,F401
from . import solvers  # noqa: E402,F401
from .gp import GP, TINY  # noqa: E402,F401
from .metrics import Metric, Subspace  # noqa: E402,F401
from .solvers import (  # noqa: E402,F401
    BasicSolver,
    TrivialSolver,
    HODLRSolver,
)

__all__ = [
    "__version__",
    "GP",
    "TINY",
    "Metric",
    "Subspace",
    "BasicSolver",
    "TrivialSolver",
    "HODLRSolver",
    "kernels",
    "metrics",
    "modeling",
    "solvers",
]
