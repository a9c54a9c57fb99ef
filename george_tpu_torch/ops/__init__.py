# -*- coding: utf-8 -*-
"""Hand-written kernels and their plain torch versions: the batched
Cholesky (``chol``: the leaf kernel and its tiled variant) and the banded
matvec (``dia``)."""

from .chol import (  # noqa: F401
    cholesky, cholesky_plain, cholesky_cuda, cholesky_tiled_cuda,
)
from .dia import dia_matvec, dia_matvec_plain, dia_matvec_cuda  # noqa: F401

__all__ = ["cholesky", "cholesky_plain", "cholesky_cuda",
           "cholesky_tiled_cuda", "dia_matvec", "dia_matvec_plain",
           "dia_matvec_cuda"]
