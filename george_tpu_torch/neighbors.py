# -*- coding: utf-8 -*-
"""Host-side data ordering and neighbor-structure normalization (the part
of ``george_tpu/neighbors.py`` that ``GP.compute`` and
``HODLRSolver.compute`` call).

Both run once per dataset on the host, in numpy; only the resulting
permutation crosses to the device.
"""

import numpy as np

__all__ = ["ragged_to_csr", "normalize_nns", "morton_sort_samples"]


def ragged_to_csr(neighbors):
    """Flatten a ragged per-row neighbor listing (one index array per
    point) into ``(nbr_idx, row_ptr)`` CSR index arrays."""
    lengths = np.fromiter(
        (np.size(row) for row in neighbors),
        count=len(neighbors), dtype=np.int64,
    )
    row_ptr = np.zeros(len(neighbors) + 1, dtype=np.int64)
    np.cumsum(lengths, out=row_ptr[1:])
    nbr_idx = (
        np.concatenate([np.ravel(row) for row in neighbors])
        if len(neighbors) else np.empty(0)
    ).astype(np.int64)
    return nbr_idx, row_ptr


def normalize_nns(nns):
    """Canonicalize a user-supplied ``nns`` neighbor structure.

    ``None`` / a bare truthy trigger, a ``(nbr_idx, row_ptr)`` CSR pair and
    a rectangular integer kNN matrix pass through; a ragged per-row listing
    is flattened to the CSR pair."""
    if nns is None or np.isscalar(nns):
        return nns
    if isinstance(nns, tuple) and len(nns) == 2:
        return nns
    arr = np.asarray(nns)
    if arr.dtype == object or (
        arr.ndim == 1 and len(arr) and np.ndim(arr[0]) > 0
    ):
        return ragged_to_csr(nns)
    return nns


def morton_sort_samples(samples, bits=21):
    """Z-order (Morton) curve ordering for hierarchical-solver locality.

    A space-filling-curve sort keeps near points in near leaf blocks, which
    is what makes HODLR off-diagonal blocks low-rank in ndim > 1. O(n log n),
    host-side, returns a permutation. For 1-D input this reduces to argsort.
    """
    samples = np.ascontiguousarray(np.atleast_2d(samples), dtype=np.float64)
    n, d = samples.shape
    if d == 1:
        return np.argsort(samples[:, 0], kind="stable")
    lo = samples.min(axis=0)
    hi = samples.max(axis=0)
    span = np.where(hi > lo, hi - lo, 1.0)
    # Quantize each axis to `bits` bits and interleave bitwise into one code.
    q = np.minimum(
        ((samples - lo) / span * ((1 << bits) - 1)).astype(np.uint64),
        (1 << bits) - 1,
    )
    if bits * d > 63:
        # Interleaved code would overflow uint64; lexsort is a reasonable
        # locality ordering for high-dimensional input.
        return np.lexsort(tuple(samples[:, ax] for ax in range(d - 1, -1, -1)))
    code = np.zeros(n, dtype=np.uint64)
    for b in range(bits):
        for ax in range(d):
            bit = (q[:, ax] >> np.uint64(b)) & np.uint64(1)
            code |= bit << np.uint64(b * d + ax)
    return np.argsort(code, kind="stable")
