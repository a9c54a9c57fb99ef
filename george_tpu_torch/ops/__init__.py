# -*- coding: utf-8 -*-
"""Hand-written kernels and their plain torch versions: the batched
Cholesky (``chol``: the leaf kernel and its tiled variant), the banded
matvec (``dia``) and the conjugate-gradient step (``cg``)."""

from .chol import (  # noqa: F401
    cholesky, cholesky_plain, cholesky_cuda, cholesky_tiled_cuda,
)
from .dia import dia_matvec, dia_matvec_plain, dia_matvec_cuda  # noqa: F401
from .cg import cg_step, cg_step_plain, cg_step_cuda  # noqa: F401

__all__ = ["cholesky", "cholesky_plain", "cholesky_cuda",
           "cholesky_tiled_cuda", "dia_matvec", "dia_matvec_plain",
           "dia_matvec_cuda", "cg_step", "cg_step_plain", "cg_step_cuda"]
