"""TJDS (Transpose Jagged Diagonal Storage) codec — XLA encode + decode.

Capability parity with the reference's ``smvp_tjds_compute`` encode phases
(main-cli.c:752-967: col-major sort → per-column vertical compression →
column-length reorder table → column renumber → x permutation → jagged
diagonal pack), re-designed for the device and **mathematically correct**:

* The diagonal count comes from the true maximum column length — fixing the
  reference bug where ``num_tjdiag`` was read from the *unsorted* reorder
  table (main-cli.c:865, SURVEY.md §B2) which silently drops diagonals.
* ``start_pos`` is sized/populated for every diagonal plus a final sentinel
  (fixes the off-by-one uninitialized read, SURVEY.md §B3).
* SpMV gathers x by *position within the diagonal* (= permuted column), not
  by original row (fixes SURVEY.md §B4), so general x vectors work and
  decode is possible.

Device-friendly structure: within jagged diagonal ``d`` the entries occupy
permuted columns ``0..n_d-1`` *contiguously*, so SpMV reads the permuted x
vector as a dense slice per diagonal — no gather at all on the x side. The
scatter side (irregular output rows) becomes a segment-sum over ``row_ind``.

Encode is one jitted XLA program (two device sorts + prefix builds); there
is no host loop over columns or diagonals.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from smvp_toolkit_tpu.formats.coo import COOMatrix

__all__ = ["TJDSMatrix", "tjds_encode", "tjds_decode"]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class TJDSMatrix:
    """Transpose Jagged Diagonal Storage (static padded shapes).

    Compressed footprint = ``vals`` + ``row_ind`` + ``start_pos`` (first
    ``num_diags + 1`` entries) + ``perm`` — the reference's ``TJDSData``
    inventory (main-cli.c:70-75) plus the column permutation it implicitly
    bakes into the reordered x vector. ``offsets`` is derived scratch
    (position-within-diagonal, reconstructible from ``start_pos``) kept for
    gather-free SpMV; excluded from footprint accounting.
    """

    vals: jax.Array  # dtype[nnz_padded], packed by (diag, position)
    row_ind: jax.Array  # int32[nnz_padded], original row per entry
    start_pos: jax.Array  # int32[diag_bound + 1], prefix starts (then nnz)
    perm: jax.Array  # int32[ncols]: original column at permuted position k
    offsets: jax.Array  # int32[nnz_padded]: position within diagonal
    num_diags: jax.Array  # int32 scalar: true number of jagged diagonals
    shape: Tuple[int, int] = dataclasses.field(metadata=dict(static=True))
    nnz: int = dataclasses.field(metadata=dict(static=True))

    @property
    def nnz_padded(self) -> int:
        return int(self.vals.shape[0])

    @property
    def dtype(self):
        return self.vals.dtype

    @property
    def nrows(self) -> int:
        return self.shape[0]

    @property
    def ncols(self) -> int:
        return self.shape[1]

    @property
    def diag_bound(self) -> int:
        """Static upper bound on the diagonal count (start_pos length - 1)."""
        return int(self.start_pos.shape[0]) - 1

    def footprint_bytes(self) -> int:
        """Compressed footprint at true sizes (vals+row_ind+start_pos+perm)."""
        isz = np.dtype(np.int32).itemsize
        vsz = jnp.dtype(self.dtype).itemsize
        ndiag = int(self.num_diags)
        return (
            self.nnz * (isz + vsz)  # row_ind + vals
            + (ndiag + 1) * isz  # start_pos
            + self.ncols * isz  # perm
        )

    def __repr__(self) -> str:
        return (
            f"TJDSMatrix(shape={self.shape}, nnz={self.nnz}, "
            f"padded={self.nnz_padded}, diags<={self.diag_bound}, "
            f"dtype={self.dtype})"
        )


def _max_col_count(coo: COOMatrix) -> int:
    """Longest column's entry count (the true jagged-diagonal count).

    Host numpy on the pulled column array: a device reduce here would be
    one extra XLA compile per (shape, nnz) signature, for a scalar the
    host computes in microseconds.
    """
    ncols = coo.shape[1]
    if ncols == 0 or coo.nnz == 0:
        return 0
    cols = np.asarray(coo.cols)[: coo.nnz]
    return int(np.bincount(cols, minlength=ncols).max())


@partial(jax.jit, static_argnames=("diag_bound",))
def _tjds_encode_impl(coo: COOMatrix, diag_bound: int) -> TJDSMatrix:
    nrows, ncols = coo.shape
    nnz = coo.nnz
    npad = coo.nnz_padded

    valid = jnp.arange(npad, dtype=jnp.int32) < nnz
    rows = jnp.where(valid, coo.rows, nrows).astype(jnp.int32)
    cols = jnp.where(valid, coo.cols, ncols).astype(jnp.int32)
    vals = jnp.where(valid, coo.vals, 0)

    # Phase 1 — column lengths (reference TXTable build, main-cli.c:845-862),
    # as a bincount instead of a scan over sorted triplets.
    counts = jnp.bincount(cols, length=ncols + 1)[:ncols].astype(jnp.int32)

    # Phase 2 — column permutation by descending length, ties by column id
    # (reference qsort desc, main-cli.c:868). lexsort: last key is primary.
    perm = jnp.lexsort((jnp.arange(ncols, dtype=jnp.int32), -counts)).astype(
        jnp.int32
    )
    # rank[orig_col] = permuted position.
    rank = jnp.zeros((ncols + 1,), dtype=jnp.int32)
    rank = rank.at[perm].set(jnp.arange(ncols, dtype=jnp.int32))
    rank = rank.at[ncols].set(ncols)  # padding sentinel maps to itself

    new_col = rank[cols]  # permuted column per entry (ncols for padding)

    # Phase 3 — vertical compression: position of each entry within its
    # column, ordered by original row (reference main-cli.c:789-826).
    # Sort by (new_col, row); rank-in-column = index - column start.
    order1 = jnp.lexsort((rows, new_col))
    nc1 = new_col[order1]
    rows1 = rows[order1]
    vals1 = vals[order1]
    col_start = jnp.searchsorted(nc1, nc1, side="left").astype(jnp.int32)
    diag = jnp.arange(npad, dtype=jnp.int32) - col_start  # jagged diagonal id
    diag = jnp.where(nc1 >= ncols, diag_bound, diag)  # padding → last bucket

    # Phase 4 — pack by (diagonal, position): within diagonal d the entries
    # occupy permuted columns 0..n_d-1 contiguously (columns sorted by
    # descending length guarantee density), reference main-cli.c:926-967.
    order2 = jnp.lexsort((nc1, diag))
    diag2 = diag[order2]
    vals_p = vals1[order2]
    rows_p = rows1[order2]
    offs_p = jnp.where(
        jnp.arange(npad, dtype=jnp.int32) < nnz, nc1[order2], 0
    ).astype(jnp.int32)

    # start_pos for every diagonal + sentinel (fixes SURVEY.md §B2/§B3);
    # diagonals past num_diags (and padding) collapse to start_pos == nnz.
    start_pos = jnp.searchsorted(
        diag2, jnp.arange(diag_bound + 1, dtype=jnp.int32), side="left"
    ).astype(jnp.int32)
    start_pos = jnp.minimum(start_pos, nnz)
    num_diags = counts.max() if ncols > 0 else jnp.int32(0)

    return TJDSMatrix(
        vals=vals_p,
        row_ind=rows_p,
        start_pos=start_pos,
        perm=perm,
        offsets=offs_p,
        num_diags=num_diags.astype(jnp.int32),
        shape=coo.shape,
        nnz=nnz,
    )


def _tjds_encode_native(coo: COOMatrix, diag_bound: int):
    """Host fast path: native counting-sort pack (bit-identical order)."""
    from smvp_toolkit_tpu.formats import encode_native as en

    r, c, v = en.host_triplets(coo)
    got = en.tjds_order(
        r, c, coo.nnz, coo.shape[0], coo.shape[1], diag_bound
    )
    if got is None:  # pragma: no cover — lib vanished between checks
        return None
    order, offsets, perm, start_pos, num_diags = got
    return TJDSMatrix(
        vals=jnp.asarray(v[order]),
        row_ind=jnp.asarray(r[order]),
        start_pos=jnp.asarray(start_pos),
        perm=jnp.asarray(perm),
        offsets=jnp.asarray(offsets),
        num_diags=jnp.asarray(np.int32(num_diags)),
        shape=coo.shape,
        nnz=coo.nnz,
    )


def tjds_encode(coo: COOMatrix) -> TJDSMatrix:
    """Encode COO → TJDS: native host counting sorts when the triplets
    are host-reachable (O(nnz), no compile), else the jitted XLA sorts.
    Both produce identical arrays.

    The diagonal-count bound is measured first (host bincount) so
    ``start_pos`` is sized O(num_diags), not O(nnz_padded) — a 10M-nnz
    matrix must not carry a 40 MB prefix array for a format whose point
    is compression. The bound rounds up to a multiple of 8 to bucket
    recompiles of the XLA encoder.
    """
    nd = _max_col_count(coo)
    diag_bound = max(-(-nd // 8) * 8, 8)
    from smvp_toolkit_tpu.formats import encode_native as en

    if en.use_native(coo):
        out = _tjds_encode_native(coo, diag_bound)
        if out is not None:
            return out
    return _tjds_encode_impl(coo, diag_bound)


@jax.jit
def _tjds_decode_impl(tjds: TJDSMatrix) -> COOMatrix:
    """Decode TJDS → COO from the compressed footprint only.

    Reconstructs position-within-diagonal from ``start_pos`` (not the cached
    ``offsets``) to prove the compressed representation is self-contained.
    """
    npad = tjds.nnz_padded
    j = jnp.arange(npad, dtype=jnp.int32)
    # diagonal of entry j: start_pos is non-decreasing, == nnz past the end.
    d = jnp.searchsorted(tjds.start_pos, j, side="right").astype(jnp.int32) - 1
    d = d.clip(0, tjds.diag_bound)
    offset = j - tjds.start_pos[d]
    valid = j < tjds.nnz
    ncols = tjds.ncols
    offset = jnp.where(valid, offset, 0).clip(0, max(ncols - 1, 0))
    cols = jnp.where(valid, tjds.perm[offset], 0).astype(jnp.int32)
    rows = jnp.where(valid, tjds.row_ind, tjds.nrows).astype(jnp.int32)
    vals = jnp.where(valid, tjds.vals, 0)
    return COOMatrix(
        rows=rows, cols=cols, vals=vals, shape=tjds.shape, nnz=tjds.nnz
    )


def tjds_decode(tjds: TJDSMatrix) -> COOMatrix:
    """Decode TJDS → COO, bit-exact on indices and stored values."""
    return _tjds_decode_impl(tjds)
