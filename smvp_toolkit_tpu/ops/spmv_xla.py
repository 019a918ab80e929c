"""SpMV y = A·x — pure-XLA implementations (the portable compute path).

The reference computes SpMV with sequential pointer-chasing loops
(CSR: ``for row: for j in row_ptr[row]..row_ptr[row+1]`` main-cli.c:410-416;
TJDS: ``for d: for j in start_pos[d]..start_pos[d+1]`` main-cli.c:1013-1020).
On the device both become one vectorized program: gather x per nonzero,
multiply, and segment-reduce into y, with no data-dependent control flow.

These are the portable kernels and the reference the other routes are
checked against; on a GPU the CLI's CSR default is the cuSPARSE route
(``ops/spmv_cusparse.py``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from smvp_toolkit_tpu.formats.coo import COOMatrix
from smvp_toolkit_tpu.formats.csr import CSRMatrix, _row_ids_from_ptr
from smvp_toolkit_tpu.formats.tjds import TJDSMatrix

__all__ = [
    "spmv_coo",
    "spmv_csr",
    "spmv_csr_cumsum",
    "spmv_tjds",
    "spmm_csr",
    "spmm_tjds",
]


@jax.jit
def spmv_coo(coo: COOMatrix, x: jax.Array) -> jax.Array:
    """y = A·x from COO triplets (device oracle).

    Padding entries carry ``row == nrows`` and are dropped by the
    segment-sum's ``num_segments`` bound; their ``val == 0`` makes the
    clipped x-gather harmless.
    """
    products = coo.vals * x[coo.cols]
    return jax.ops.segment_sum(products, coo.rows, num_segments=coo.shape[0])


@jax.jit
def spmv_csr(csr: CSRMatrix, x: jax.Array) -> jax.Array:
    """y = A·x from CSR: gather x by col_ind, sorted segment-sum by row.

    Replaces the reference hot loop main-cli.c:410-416. Uses the cached
    ``row_ids`` when present (encode produces them) so the reduction can
    declare ``indices_are_sorted`` — XLA then emits a segmented prefix
    reduction instead of a scatter.
    """
    row_ids = csr.row_ids if csr.row_ids is not None else _row_ids_from_ptr(csr)
    products = csr.vals * x[csr.col_ind]
    return jax.ops.segment_sum(
        products,
        row_ids,
        num_segments=csr.shape[0],
        indices_are_sorted=True,
    )


@jax.jit
def spmv_csr_cumsum(csr: CSRMatrix, x: jax.Array) -> jax.Array:
    """y = A·x from CSR via the cumsum-difference trick (scatter-free).

    ``y[r] = P[row_ptr[r+1]] - P[row_ptr[r]]`` where P is the exclusive
    prefix sum of per-nonzero products — two gathers and a scan, no scatter
    at all. Accumulation order matches in-row sequential order; the extra
    rounding from the global prefix is the usual f32 cumsum caveat.
    """
    products = csr.vals * x[csr.col_ind]
    # Zero out padding (vals are already 0 there, but stay defensive).
    prefix = jnp.cumsum(products)
    prefix = jnp.concatenate([jnp.zeros((1,), dtype=prefix.dtype), prefix])
    return prefix[csr.row_ptr[1:]] - prefix[csr.row_ptr[:-1]]


@jax.jit
def spmm_csr(csr: CSRMatrix, x: jax.Array) -> jax.Array:
    """Y = A·X for a block of vectors X (ncols, k) — sparse × dense.

    Multi-vector capability beyond the reference (which only ever
    multiplies one ones-vector). The k dimension rides along the gather
    and the segment reduction.
    """
    row_ids = csr.row_ids if csr.row_ids is not None else _row_ids_from_ptr(csr)
    products = csr.vals[:, None] * x[csr.col_ind, :]
    return jax.ops.segment_sum(
        products,
        row_ids,
        num_segments=csr.shape[0],
        indices_are_sorted=True,
    )


@jax.jit
def spmm_tjds(tjds: TJDSMatrix, x: jax.Array) -> jax.Array:
    """Y = A·X from TJDS for a block of vectors X (ncols, k)."""
    xp = x[tjds.perm, :]
    products = tjds.vals[:, None] * xp[tjds.offsets, :]
    return jax.ops.segment_sum(
        products, tjds.row_ind, num_segments=tjds.shape[0]
    )


@jax.jit
def spmv_tjds(tjds: TJDSMatrix, x: jax.Array) -> jax.Array:
    """y = A·x from TJDS (fixes the reference §B2-§B4 bugs by design).

    The permuted x vector is read by position-within-diagonal — within
    diagonal ``d`` positions run 0..n_d-1 contiguously, so on the packed
    layout this is ``xp[offsets]`` with ``offsets`` a concatenation of
    iotas (contiguous slices of xp). The irregular output rows become a segment-sum over
    ``row_ind`` (padding rows == nrows are dropped by ``num_segments``).
    """
    xp = x[tjds.perm]
    products = tjds.vals * xp[tjds.offsets]
    return jax.ops.segment_sum(
        products, tjds.row_ind, num_segments=tjds.shape[0]
    )
