# -*- coding: utf-8 -*-
"""Hand-written kernels and their plain torch versions."""

from .chol import cholesky, cholesky_plain, cholesky_cuda  # noqa: F401

__all__ = ["cholesky", "cholesky_plain", "cholesky_cuda"]
