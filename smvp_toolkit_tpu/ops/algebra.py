"""Sparse algebra utilities on COO triplets (device, jitted).

Small building blocks the reference never needed (its only op is the
benchmark SpMV) but any consumer of a sparse library does: transpose,
diagonal extraction (feeds :func:`~smvp_toolkit_tpu.models.jacobi` /
``pcg``), row/column sums (degree vectors for graph normalizations),
linear combination and scaling. All static-shape, padding-safe
(padding rows carry ``row == nrows`` and ``val == 0``).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from smvp_toolkit_tpu.formats.coo import COOMatrix

__all__ = [
    "transpose",
    "diagonal",
    "row_sums",
    "col_sums",
    "scale",
    "add",
    "matmul",
]


@jax.jit
def diagonal(coo: COOMatrix) -> jax.Array:
    """Main diagonal as a dense vector (duplicates summed).

    The Jacobi/PCG preconditioner input: ``pcg(csr, b, diagonal(coo))``.
    """
    n = min(coo.shape)
    on_diag = (coo.rows == coo.cols) & (coo.rows < n)
    vals = jnp.where(on_diag, coo.vals, 0)
    idx = jnp.where(on_diag, coo.rows, n)
    return jax.ops.segment_sum(vals, idx, num_segments=n + 1)[:n]


@jax.jit
def row_sums(coo: COOMatrix) -> jax.Array:
    """Σ_j A[i, j] per row (padding rows drop via the sentinel)."""
    return jax.ops.segment_sum(
        coo.vals, coo.rows, num_segments=coo.shape[0]
    )


@jax.jit
def col_sums(coo: COOMatrix) -> jax.Array:
    """Σ_i A[i, j] per column (padding vals are 0, so clipping is safe)."""
    return jax.ops.segment_sum(
        jnp.where(coo.rows < coo.shape[0], coo.vals, 0),
        jnp.minimum(coo.cols, coo.shape[1] - 1),
        num_segments=coo.shape[1],
    )


def transpose(coo: COOMatrix) -> COOMatrix:
    """Aᵀ as a new COO (entries re-sorted row-major, padding kept last).

    A non-general symmetry claim is dropped: transposing flips which
    triangle is *stored*, so downstream consumers of the typecode's
    stored-lower convention (writers, expansion) must treat the result
    as general.
    """
    r = jnp.where(coo.rows < coo.shape[0], coo.cols, coo.shape[1])
    c = jnp.where(coo.rows < coo.shape[0], coo.rows, 0)
    order = jnp.lexsort((c, r))
    tc = coo.typecode
    if tc.symmetry != "general":
        tc = dataclasses.replace(tc, symmetry="general")
    return dataclasses.replace(
        coo,
        rows=r[order],
        cols=c[order],
        vals=coo.vals[order],
        shape=(coo.shape[1], coo.shape[0]),
        typecode=tc,
    )


def scale(coo: COOMatrix, alpha) -> COOMatrix:
    """alpha · A (padding zeros stay zero)."""
    return dataclasses.replace(coo, vals=coo.vals * alpha)


def _as_general(m: COOMatrix) -> COOMatrix:
    """Full (mirrored) storage of a one-triangle operand, typed general."""
    if m.typecode.is_general:
        return m
    r, c, v = m._export_triplets()
    return COOMatrix.from_numpy(
        r, c, v, shape=m.shape, dtype=m.vals.dtype,
        pad_to=max(128, m.rows.shape[0]),
    )


def matmul(a: COOMatrix, b: COOMatrix, *, pad_to: int = 128) -> COOMatrix:
    """A @ B as a new sparse COO (SpGEMM).

    The output sparsity pattern is data-dependent — its nnz cannot be
    known before the product is formed — so no static-shape device
    program can produce it directly. This is therefore an ENCODE-TIME
    host operation (scipy's CSR SpGEMM); the
    result lands back on device as a fresh COO. Use it to precompute
    operator products (normal equations AᵀA, graph powers A²) that the
    device SpMV/solvers then iterate on. For dense right-hand blocks
    use the device SpMM (`ops.spmm_csr`); for applying A·B·x once,
    compose two SpMVs instead — that needs no product matrix at all.

    Symmetric/skew/hermitian operands are expanded before multiplying
    (product symmetry is not preserved in general); explicit zeros in
    the product are kept out by scipy's CSR algebra.
    """
    if a.shape[1] != b.shape[0]:
        raise ValueError(
            f"inner dimensions differ: {a.shape} @ {b.shape}"
        )
    out = (a.to_scipy().tocsr() @ b.to_scipy().tocsr()).tocoo()
    return COOMatrix.from_scipy(out, pad_to=pad_to)


def add(a: COOMatrix, b: COOMatrix, beta=1.0) -> COOMatrix:
    """A + beta·B as a concatenated COO (duplicates kept, summed on use).

    Both operands must share the same shape. The result's padded length
    is the sum of the operands' padded lengths — call ``.pad()`` or
    re-encode downstream as usual; duplicate (row, col) entries are
    legal COO and every consumer (encoders, SpMV, ``to_dense``) sums
    them.

    Symmetry conventions must agree before raw triplets can be mixed: a
    one-triangle operand added to a general one would either never get
    its mirrored triangle expanded or get mirrored entries it doesn't
    own. Mismatched (or hermitian-with-complex-``beta``) operands are
    expanded to full general storage first; operands sharing a symmetry
    keep one-triangle storage (the sum of two stored-lower triangles is
    the stored-lower triangle of the sum).
    """
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch: {a.shape} vs {b.shape}")
    sym_a, sym_b = a.typecode.symmetry, b.typecode.symmetry
    hermitian_break = sym_a == "hermitian" and jnp.iscomplexobj(
        jnp.asarray(beta)
    )
    if sym_a != sym_b or hermitian_break:
        a, b = _as_general(a), _as_general(b)
    # Strip padding first — a's padding entries must not sit between the
    # real entries of a and b (to_numpy slices the first nnz entries).
    return dataclasses.replace(
        a,
        rows=jnp.concatenate([a.rows[: a.nnz], b.rows[: b.nnz]]),
        cols=jnp.concatenate([a.cols[: a.nnz], b.cols[: b.nnz]]),
        vals=jnp.concatenate([a.vals[: a.nnz], b.vals[: b.nnz] * beta]),
        nnz=a.nnz + b.nnz,
    )
