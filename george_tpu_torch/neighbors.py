# -*- coding: utf-8 -*-
"""Host-side neighbor search, data ordering and neighbor-structure
normalization (the part of ``george_tpu/neighbors.py`` that ``GP.compute``,
``HODLRSolver.compute`` and ``SparseSolver.compute`` call).

All of it runs once per dataset on the host, in numpy; only the resulting
index structures (CSR arrays, permutations) cross to the device. The radius
query is ``scipy.spatial.cKDTree`` (the JAX package's fallback; its in-tree
C++ kd-tree is not needed here); so are the kNN query and the
distance ordering.
"""

import numpy as np

__all__ = ["radius_neighbors_csr", "ragged_to_csr", "knn_matrix_to_csr",
           "normalize_nns", "knn_indices", "nd_sort_samples",
           "morton_sort_samples"]


def _pairs_to_csr(rows, cols, n):
    """CSR ``(nbr_idx, row_ptr)`` of the (row, col) pairs, each row's
    columns ascending; duplicate pairs are kept."""
    key = np.sort(rows.astype(np.int64) * n + cols.astype(np.int64))
    row_ptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(key // n, minlength=n), out=row_ptr[1:])
    return key % n, row_ptr


def radius_neighbors_csr(x, radius):
    """All neighbors within ``radius`` of each point, as CSR arrays.

    Returns ``(nbr_idx, row_ptr)`` with ``nbr_idx[row_ptr[i]:row_ptr[i+1]]``
    the neighbor indices of point ``i`` in ascending order (self included).
    Vectorized: one ``cKDTree.query_pairs`` for the pairs ``i < j`` at
    distance ``<= radius``, mirrored, plus the diagonal, sorted by one
    integer key, with no per-row Python loop (n = 2e5 points with ~200
    neighbors each pass through here).
    """
    x = np.ascontiguousarray(np.atleast_2d(x), dtype=np.float64)
    n = len(x)
    if not np.isfinite(radius) or radius <= 0:
        # Dense fallback: everything neighbors everything.
        row_ptr = np.arange(0, n * n + 1, n, dtype=np.int64)
        nbr_idx = np.tile(np.arange(n, dtype=np.int64), n)
        return nbr_idx, row_ptr

    from scipy.spatial import cKDTree

    pairs = cKDTree(x).query_pairs(float(radius), output_type="ndarray")
    eye = np.arange(n, dtype=np.int64)
    rows = np.concatenate([pairs[:, 0], pairs[:, 1], eye])
    cols = np.concatenate([pairs[:, 1], pairs[:, 0], eye])
    return _pairs_to_csr(rows, cols, n)


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


def knn_matrix_to_csr(arr, n):
    """Symmetrized CSR pattern from a rectangular kNN matrix (one
    fixed-size neighbor list per row, ``-1`` = missing). kNN relations are
    not symmetric, but the sparse solver's operator must be: the pattern is
    the union ``{(i,j)} U {(j,i)} U {(i,i)}``, deduplicated."""
    arr = np.asarray(arr, dtype=np.int64)
    i0 = np.repeat(np.arange(n, dtype=np.int64), arr.shape[1])
    j0 = arr.ravel()
    keep = (j0 >= 0) & (j0 < n)
    i0, j0 = i0[keep], j0[keep]
    eye = np.arange(n, dtype=np.int64)
    nbr_idx, row_ptr = _pairs_to_csr(np.concatenate([i0, j0, eye]),
                                     np.concatenate([j0, i0, eye]), n)
    # drop repeats: after the sort, equal pairs are adjacent
    rows = np.repeat(eye, np.diff(row_ptr))
    uniq = np.ones(len(nbr_idx), dtype=bool)
    uniq[1:] = (rows[1:] != rows[:-1]) | (nbr_idx[1:] != nbr_idx[:-1])
    row_ptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(rows[uniq], minlength=n), out=row_ptr[1:])
    return nbr_idx[uniq], row_ptr


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


def knn_indices(x, k):
    """Indices ``(n, k)`` of the ``k`` nearest neighbors of each point
    (self included), nearest first."""
    from scipy.spatial import cKDTree

    x = np.ascontiguousarray(np.atleast_2d(x), dtype=np.float64)
    _, idx = cKDTree(x).query(x, k=int(k))
    return np.atleast_2d(idx).astype(np.int64)


def nd_sort_samples(samples):
    """The permutation that orders the samples by distance from
    ``samples[0]``, in kd-tree query order."""
    from scipy.spatial import cKDTree

    samples = np.ascontiguousarray(samples, dtype=np.float64)
    if samples.ndim != 2:
        raise ValueError("samples must be a 2-D array")
    _, i = cKDTree(samples).query(samples[0], k=len(samples))
    return i


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
