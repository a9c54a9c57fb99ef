# -*- coding: utf-8 -*-
"""george-tpu-torch: the PyTorch and CUDA port of george-tpu.

Two paths of ``george_tpu``, written in PyTorch for an NVIDIA H100:

* the hierarchical (HODLR) marginal log-likelihood: the kernel zoo
  generated from the same YAML specs, the HODLR solver in its transposed
  cascade layout with exact-autograd and Hutchinson gradients;
* the compact-support sparse solver for ``WendlandC2Kernel``: CG + SLQ with
  Hutchinson gradients over a banded (DIA) or padded-neighbor (ELL)
  layout, and the exact block-tridiagonal Cholesky on sorted 1-D data;

with the dense and trivial solvers and the ``GP`` object. The kernels on
CUDA tensors are CUDA C++ written for ``sm_90a`` (``csrc/``: the leaf
Cholesky, its tiled one-warp-per-block variant, the DIA matvec), built from
source at first use.

The package imports ``torch``, ``numpy`` and ``scipy`` only — never JAX or
the JAX package. The solvers and the GP take ``device=`` (default
``"cuda"``, never chosen automatically: pass ``device="cpu"`` on a host
without a card) and ``dtype=``.

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
    SparseSolver,
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
    "SparseSolver",
    "kernels",
    "metrics",
    "modeling",
    "solvers",
]
