# -*- coding: utf-8 -*-
"""Carry parameters and solver state from the JAX package to the port.

Both functions take plain numpy and Python values — what the JAX objects'
accessors return — so nothing of JAX is imported here:

* :func:`kernel_from_reference` sets a port kernel's parameters from a JAX
  kernel's ``get_parameter_names()`` / ``get_parameter_vector()``. Port
  kernels keep the JAX kernels' parameter names and order, so this checks
  the names and sets the vector.
* :func:`structure_from_arrays` builds the port's ``HODLRStructure`` around
  the JAX structure's per-level pivot arrays, so a comparison of the two
  factorizations is not a comparison of two pivot walks.
"""

import numpy as np

from .solvers.hodlr import HODLRStructure

__all__ = ["kernel_from_reference", "structure_from_arrays"]


def kernel_from_reference(kernel, names, vector, include_frozen=False):
    """Set ``kernel``'s parameters from a reference kernel's parameter
    names and vector; returns ``kernel``. Raises ``ValueError`` when the
    names differ (the two kernels are built differently)."""
    own = tuple(kernel.get_parameter_names(include_frozen=include_frozen))
    if own != tuple(names):
        raise ValueError(
            "parameter names differ: port %s vs reference %s"
            % (own, tuple(names))
        )
    kernel.set_parameter_vector(
        np.asarray(vector, dtype=np.float64), include_frozen=include_frozen
    )
    return kernel


def structure_from_arrays(n, min_size, rank, seed, levels, ridge_floor=None):
    """The port's ``HODLRStructure`` for ``n`` points, with the skeleton
    pivots of ``levels``: one ``(row_piv, col_piv)`` pair of numpy arrays
    per level, root split first, in absolute padded-row indices (the
    ``"row_piv"``/``"col_piv"`` entries of the JAX structure's
    ``levels``)."""
    return HODLRStructure(
        n, min_size=min_size, rank=rank, seed=seed, ridge_floor=ridge_floor,
        pivots=[(np.asarray(r), np.asarray(c)) for r, c in levels],
    )
