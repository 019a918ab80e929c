"""Synthetic sparse-matrix generators (benchmark + test inputs).

BASELINE.json's multi-host config names a "synthetic 10M-nnz matrix";
these generators produce reproducible banded / uniform / power-law
patterns at any scale without shipping large files.

:func:`sample_triplets` stands in for the reference toolkit's sample
matrices, which are not distributed with this repository: same shape,
nonzero count and MatrixMarket type code, pattern generated from a
fixed seed.
"""

from __future__ import annotations

import os
import zlib
from typing import Optional, Tuple

import numpy as np

from smvp_toolkit_tpu.formats.coo import COOMatrix

__all__ = [
    "synth_banded",
    "synth_uniform",
    "synth_powerlaw",
    "SAMPLE_MATRICES",
    "sample_triplets",
    "sample_matrix",
    "write_sample_mtx",
]

# name -> (n, nnz, field, symmetry): the reference's sample-data
# inventory (SURVEY.md, "Sample data"). All are square.
SAMPLE_MATRICES = {
    "ibm32": (32, 126, "pattern", "general"),
    "curtis54": (54, 291, "pattern", "general"),
    "pdp08-pg4": (6, 16, "real", "general"),
    "memplus": (17758, 126150, "real", "general"),
    "pwt": (36519, 181313, "pattern", "symmetric"),
}


def synth_banded(
    n: int, nnz_per_row: int = 9, bandwidth: int = 64, seed: int = 0,
    dtype=None,
) -> COOMatrix:
    """Banded SPD-ish pattern: entries within ±bandwidth of the diagonal."""
    rng = np.random.RandomState(seed)
    rows = np.repeat(np.arange(n, dtype=np.int64), nnz_per_row)
    offs = rng.randint(-bandwidth, bandwidth + 1, size=len(rows))
    cols = np.clip(rows + offs, 0, n - 1)
    vals = rng.randn(len(rows))
    return _dedup(rows, cols, vals, (n, n), dtype)


def synth_uniform(
    nrows: int, ncols: int, nnz: int, seed: int = 0, dtype=None
) -> COOMatrix:
    """Uniformly scattered pattern (worst-case locality)."""
    rng = np.random.RandomState(seed)
    rows = rng.randint(0, nrows, size=nnz).astype(np.int64)
    cols = rng.randint(0, ncols, size=nnz).astype(np.int64)
    vals = rng.randn(nnz)
    return _dedup(rows, cols, vals, (nrows, ncols), dtype)


def synth_powerlaw(
    n: int, nnz: int, alpha: float = 1.5, seed: int = 0, dtype=None
) -> COOMatrix:
    """Power-law column popularity (hub columns, e.g. circuit/web graphs)."""
    rng = np.random.RandomState(seed)
    popularity = (np.arange(1, n + 1, dtype=np.float64)) ** (-alpha)
    popularity /= popularity.sum()
    rows = rng.randint(0, n, size=nnz).astype(np.int64)
    cols = rng.choice(n, size=nnz, p=popularity).astype(np.int64)
    vals = rng.randn(nnz)
    return _dedup(rows, cols, vals, (n, n), dtype)


def _dedup(rows, cols, vals, shape: Tuple[int, int], dtype) -> COOMatrix:
    """Drop duplicate (row, col) pairs (keep first) and sort row-major."""
    key = rows * shape[1] + cols
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    keep = np.ones(len(key_s), dtype=bool)
    keep[1:] = key_s[1:] != key_s[:-1]
    sel = order[keep]
    return COOMatrix.from_numpy(
        rows[sel].astype(np.int32),
        cols[sel].astype(np.int32),
        vals[sel],
        shape=shape,
        dtype=dtype,
    )


def parse_synth_spec(spec: str):
    """Parse ``synth:N:NNZ`` into a banded COO matrix.

    Shared by the CLI and the distributed launch runner so the spec
    grammar and its error behavior stay in one place. Raises ValueError
    with a user-readable message on a malformed spec.
    """
    parts = spec.split(":")
    if len(parts) != 3 or parts[0] != "synth":
        raise ValueError(f"bad synth spec (want synth:N:NNZ): {spec!r}")
    try:
        n, nnz = int(parts[1]), int(parts[2])
    except ValueError:
        raise ValueError(
            f"bad synth spec (want synth:N:NNZ): {spec!r}"
        ) from None
    if n < 1 or nnz < 0:
        raise ValueError(f"bad synth spec (non-positive sizes): {spec!r}")
    return synth_banded(n, nnz_per_row=max(nnz // n, 1))


def sample_triplets(
    name: str,
) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray], Tuple[int, int]]:
    """Stand-in for reference sample ``name``: ``(rows, cols, vals, shape)``.

    0-based stored entries in column-major order, as MatrixMarket files
    are usually written; ``vals`` is None for a pattern matrix. The full
    diagonal plus unique off-diagonal entries within a band of ``n // 8``
    (at least 2); a symmetric matrix stores its lower triangle only. Real
    values are uniform in [-1, 1) off the diagonal, and each diagonal
    entry is 1 plus its row's off-diagonal magnitudes, so the matrix is
    nonsingular and solvers stay finite on it.
    """
    n, nnz, field, symmetry = SAMPLE_MATRICES[name]
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    diag = np.arange(min(n, nnz), dtype=np.int64)
    need = nnz - diag.size
    band = max(2, n // 8)
    keys = np.empty(0, np.int64)
    while keys.size < need:
        k = 2 * (need - keys.size) + 8
        r = rng.integers(0, n, k)
        off = rng.integers(1, band + 1, k)
        if symmetry == "general":
            off = np.where(rng.random(k) < 0.5, -off, off)
        c = r - off
        ok = (c >= 0) & (c < n)
        keys = np.union1d(keys, r[ok] * n + c[ok])
    keys = rng.choice(keys, need, replace=False)
    rows = np.concatenate([diag, keys // n])
    cols = np.concatenate([diag, keys % n])
    vals = None
    if field == "real":
        off = rng.uniform(-1.0, 1.0, need)
        dom = np.bincount(rows[diag.size:], np.abs(off), minlength=n)
        vals = np.concatenate([1.0 + dom[diag], off])
    order = np.lexsort((rows, cols))
    rows, cols = rows[order].astype(np.int32), cols[order].astype(np.int32)
    return rows, cols, None if vals is None else vals[order], (n, n)


def sample_matrix(name: str, dtype=None) -> COOMatrix:
    """:func:`sample_triplets` as a COO matrix (stored entries only)."""
    from smvp_toolkit_tpu.io.mtx import MMTypeCode

    r, c, v, shape = sample_triplets(name)
    _, _, field, symmetry = SAMPLE_MATRICES[name]
    return COOMatrix.from_numpy(
        r, c, np.ones(r.size) if v is None else v, shape=shape,
        dtype=dtype,
        typecode=MMTypeCode("matrix", "coordinate", field, symmetry),
    )


def write_sample_mtx(name: str, path: str) -> None:
    """Write the stand-in for ``name`` as a ``.mtx`` file, atomically."""
    from smvp_toolkit_tpu.io.mtx import write_mtx

    r, c, v, shape = sample_triplets(name)
    _, _, field, symmetry = SAMPLE_MATRICES[name]
    tmp = f"{path}.{os.getpid()}.tmp"
    write_mtx(tmp, r, c, v, shape, field=field, symmetry=symmetry)
    os.replace(tmp, path)
