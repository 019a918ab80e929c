"""Matrix reordering utilities: RCM permutation + symmetric permute.

Host-side, encode-time tools: reordering changes the SPARSITY PATTERN,
which no static-shape device program can do. Reverse Cuthill-McKee
shrinks bandwidth — useful for ILU/IC fill quality and
locality-sensitive backends (x-gather locality in cache); its SpMV
effect on the GPU is not measured.
"""

from __future__ import annotations

import numpy as np

from smvp_toolkit_tpu.formats.coo import COOMatrix

__all__ = ["rcm_permutation", "permute_symmetric", "bandwidth"]


def bandwidth(coo: COOMatrix) -> int:
    """max |i − j| over stored entries (0 for empty/diagonal)."""
    r, c, _ = coo.to_numpy()
    if r.size == 0:
        return 0
    return int(np.abs(r.astype(np.int64) - c.astype(np.int64)).max())


def rcm_permutation(coo: COOMatrix) -> np.ndarray:
    """Reverse Cuthill-McKee ordering of a square matrix's graph.

    Returns ``perm`` such that row/col ``perm[k]`` of A becomes
    row/col ``k`` of the reordered matrix (scipy's convention). The
    graph is symmetrized first (RCM is defined on undirected graphs).
    """
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    n, m = coo.shape
    if n != m:
        raise ValueError(f"rcm needs a square matrix, got {coo.shape}")
    r, c, _ = coo.to_numpy()
    s = sp.csr_matrix(
        (np.ones(len(r)), (r, c)), shape=(n, n), dtype=np.float64
    )
    return np.asarray(
        reverse_cuthill_mckee(s + s.T, symmetric_mode=True), np.int64
    )


def permute_symmetric(coo: COOMatrix, perm: np.ndarray) -> COOMatrix:
    """P·A·Pᵀ: apply one permutation to rows AND columns.

    ``perm`` follows :func:`rcm_permutation`'s convention (old index of
    the entry that lands at each new position). Preserves values
    bit-exactly; symmetric-storage typecodes survive (a symmetric
    permutation keeps which triangle an entry falls in only for
    general storage, so symmetric/skew/hermitian inputs are expanded
    first and returned as general).
    """
    n, m = coo.shape
    if n != m:
        raise ValueError(
            f"symmetric permute needs a square matrix, got {coo.shape}"
        )
    perm = np.asarray(perm)
    if perm.shape != (n,) or not np.array_equal(
        np.sort(perm), np.arange(n)
    ):
        raise ValueError("perm must be a permutation of range(nrows)")
    from smvp_toolkit_tpu.ops.algebra import _as_general

    g = _as_general(coo)
    r, c, v = g.to_numpy()
    inv = np.empty(n, np.int64)
    inv[perm] = np.arange(n)
    return COOMatrix.from_numpy(
        inv[r].astype(r.dtype), inv[c].astype(c.dtype), v,
        shape=(n, n), pad_to=128,
    )
