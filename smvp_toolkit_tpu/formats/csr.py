"""CSR (Compressed Sparse Row) codec — XLA encode + decode.

Capability parity with the reference's CSR encoder embedded in
``smvp_csr_compute`` (main-cli.c:340-365: qsort row-major + single-pass
``row_ptr``/``col_ind``/``val`` build), re-designed for the device:

* Encode runs entirely on device under ``jit``: ``jnp.lexsort`` by
  (row, col) + a vectorized ``searchsorted`` prefix build of ``row_ptr``.
  Empty rows are handled by construction, fixing the reference's
  uninitialized ``row_ptr`` gaps (SURVEY.md §B6).
* Decode (CSR → COO) is a new capability the reference lacks
  (BASELINE.json north star): row ids are recovered from ``row_ptr`` with a
  vectorized ``searchsorted``, bit-exact on indices and stored values.
* Static shapes: ``col_ind``/``vals`` may be padded beyond ``nnz``; padded
  entries carry ``col = 0, val = 0`` and live past ``row_ptr[nrows]``.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from smvp_toolkit_tpu.formats.coo import COOMatrix

__all__ = ["CSRMatrix", "csr_encode", "csr_decode"]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class CSRMatrix:
    """Compressed Sparse Row matrix (static padded shapes).

    Compressed footprint = ``row_ptr`` + ``col_ind`` + ``vals`` — the same
    index+value inventory as the reference's ``CSRData`` (main-cli.c:61-66).
    ``row_ids`` (row index per nnz) is optional derived scratch used by
    segment-sum SpMV kernels; it is excluded from footprint accounting and
    reconstructible from ``row_ptr``.
    """

    row_ptr: jax.Array  # int32[nrows + 1]
    col_ind: jax.Array  # int32[nnz_padded]
    vals: jax.Array  # dtype[nnz_padded]
    shape: Tuple[int, int] = dataclasses.field(metadata=dict(static=True))
    nnz: int = dataclasses.field(metadata=dict(static=True))
    row_ids: Optional[jax.Array] = None  # int32[nnz_padded], derived cache

    @property
    def nnz_padded(self) -> int:
        return int(self.col_ind.shape[0])

    @property
    def dtype(self):
        return self.vals.dtype

    @property
    def nrows(self) -> int:
        return self.shape[0]

    @property
    def ncols(self) -> int:
        return self.shape[1]

    def footprint_bytes(self) -> int:
        """Compressed footprint (row_ptr + col_ind + vals), true nnz only."""
        isz = np.dtype(np.int32).itemsize
        vsz = jnp.dtype(self.dtype).itemsize
        return (self.nrows + 1) * isz + self.nnz * (isz + vsz)

    def with_row_ids(self) -> "CSRMatrix":
        """Materialize the per-nnz row index (padding → nrows sentinel)."""
        if self.row_ids is not None:
            return self
        return dataclasses.replace(self, row_ids=_row_ids_from_ptr(self))

    def __repr__(self) -> str:
        return (
            f"CSRMatrix(shape={self.shape}, nnz={self.nnz}, "
            f"padded={self.nnz_padded}, dtype={self.dtype})"
        )


def _valid_mask(coo: COOMatrix) -> jax.Array:
    return jnp.arange(coo.nnz_padded, dtype=jnp.int32) < coo.nnz


@partial(jax.jit, static_argnames=("with_row_ids",))
def _csr_encode_impl(coo: COOMatrix, with_row_ids: bool = True) -> CSRMatrix:
    nrows, _ = coo.shape
    # Padding entries carry row == nrows; force that invariant so they sort
    # last regardless of how the COO was constructed.
    valid = _valid_mask(coo)
    rows = jnp.where(valid, coo.rows, nrows).astype(jnp.int32)
    cols = jnp.where(valid, coo.cols, 0).astype(jnp.int32)
    vals = jnp.where(valid, coo.vals, 0)

    # Row-major (row, col) sort — lexsort's last key is primary.
    order = jnp.lexsort((cols, rows))
    rows_s = rows[order]
    cols_s = cols[order]
    vals_s = vals[order]

    # row_ptr[i] = #entries with row < i: a vectorized prefix build that is
    # correct for empty rows by construction (fixes SURVEY.md §B6).
    row_ptr = jnp.searchsorted(
        rows_s, jnp.arange(nrows + 1, dtype=jnp.int32), side="left"
    ).astype(jnp.int32)

    row_ids = rows_s if with_row_ids else None
    return CSRMatrix(
        row_ptr=row_ptr,
        col_ind=cols_s,
        vals=vals_s,
        shape=coo.shape,
        nnz=coo.nnz,
        row_ids=row_ids,
    )


def _csr_encode_native(
    coo: COOMatrix, with_row_ids: bool
) -> Optional[CSRMatrix]:
    """Host fast path: native stable counting sort (bit-identical order)."""
    from smvp_toolkit_tpu.formats import encode_native as en

    r, c, v = en.host_triplets(coo)
    got = en.csr_order(r, c, coo.nnz, coo.shape[0], coo.shape[1])
    if got is None:  # pragma: no cover — lib vanished between checks
        return None
    order, row_ptr = got
    return CSRMatrix(
        row_ptr=jnp.asarray(row_ptr),
        col_ind=jnp.asarray(c[order]),
        vals=jnp.asarray(v[order]),
        shape=coo.shape,
        nnz=coo.nnz,
        row_ids=jnp.asarray(r[order]) if with_row_ids else None,
    )


def csr_encode(coo: COOMatrix, *, with_row_ids: bool = True) -> CSRMatrix:
    """Encode COO → CSR: native host counting sort when the triplets are
    host-reachable (O(nnz), no compile), else the jitted XLA sort +
    prefix build. Both produce identical arrays."""
    from smvp_toolkit_tpu.formats import encode_native as en

    if en.use_native(coo):
        out = _csr_encode_native(coo, with_row_ids)
        if out is not None:
            return out
    return _csr_encode_impl(coo, with_row_ids=with_row_ids)


@jax.jit
def _row_ids_from_ptr(csr: CSRMatrix) -> jax.Array:
    """row id per nnz slot; padded slots get the ``nrows`` sentinel.

    ``searchsorted(row_ptr, j, 'right') - 1`` maps nnz position j to its row
    (row_ptr is non-decreasing with row_ptr[nrows] == nnz, so j >= nnz lands
    on the sentinel).
    """
    j = jnp.arange(csr.nnz_padded, dtype=jnp.int32)
    return (
        jnp.searchsorted(csr.row_ptr, j, side="right").astype(jnp.int32) - 1
    ).clip(0, csr.nrows)


@jax.jit
def _csr_decode_impl(csr: CSRMatrix) -> COOMatrix:
    row_ids = csr.row_ids if csr.row_ids is not None else _row_ids_from_ptr(csr)
    return COOMatrix(
        rows=row_ids,
        cols=csr.col_ind,
        vals=csr.vals,
        shape=csr.shape,
        nnz=csr.nnz,
    )


def csr_decode(csr: CSRMatrix) -> COOMatrix:
    """Decode CSR → COO (canonical row-major order), bit-exact.

    New capability vs. the reference (north star): indices and values are
    reproduced exactly as stored — no arithmetic touches them.
    """
    return _csr_decode_impl(csr)
