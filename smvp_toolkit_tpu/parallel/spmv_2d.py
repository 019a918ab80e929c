"""2-D sharded SpMV: row x column blocks over a 2-D device mesh.

The "tensor-parallel structural cousin" SURVEY.md §2 names as the
stretch feature: 1-D row-block DP replicates x on every device, which
caps the solvable problem at one chip's x/y footprint and leaves wide
rows on a single device. Here BOTH matrix dimensions shard:

* the mesh is (``dpr``, ``dpc``) — R row blocks x C column blocks,
* device (i, j) owns the nonzeros of row block i whose columns fall in
  column block j,
* x is **sharded along dpc** (replicated along dpr) — each device reads
  only its 1/C of x,
* each device segment-sums its partial y block; a ``psum`` along dpc
  reduces the column-block partials (the TP-style collective), and an
  ordered ``all_gather`` along dpr reassembles row order.

At C = 1 this degrades to the 1-D row-block design
(``spmv_dist.py``); at R = 1 it is pure column parallelism (x sharded,
y reduced). Collectives ride the mesh axes like TP matmul sharding;
on GPUs joined all to all by NVLink the mesh shape follows the
algorithm alone.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from smvp_toolkit_tpu.formats.csr import CSRMatrix
from smvp_toolkit_tpu.parallel.spmv_dist import _csr_entry_rows, _round_up

__all__ = [
    "ShardedCSR2D",
    "make_mesh_2d",
    "shard_csr_2d",
    "spmv_csr_2d",
    "spmm_csr_2d",
]

DPR_AXIS = "dpr"
DPC_AXIS = "dpc"


def make_mesh_2d(rows: int, cols: int, devices=None) -> Mesh:
    """A (rows, cols) mesh over rows*cols devices."""
    if devices is None:
        devices = jax.devices()
    if rows * cols > len(devices):
        raise ValueError(
            f"mesh {rows}x{cols} needs {rows * cols} devices, "
            f"only {len(devices)} present"
        )
    grid = np.asarray(devices[: rows * cols]).reshape(rows, cols)
    return Mesh(grid, (DPR_AXIS, DPC_AXIS))


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ShardedCSR2D:
    """Per-device (row-block, col-block) entry sets, equal padded width.

    ``local_rows``/``local_cols`` are block-relative; padding entries
    carry ``local_rows == rows_blk`` (dropped by ``num_segments``) and
    zero values.
    """

    vals: jax.Array  # dtype[R, C, nnz_blk]
    local_cols: jax.Array  # int32[R, C, nnz_blk]
    local_rows: jax.Array  # int32[R, C, nnz_blk]
    shape: Tuple[int, int] = dataclasses.field(metadata=dict(static=True))
    nnz: int = dataclasses.field(metadata=dict(static=True))
    rows_blk: int = dataclasses.field(metadata=dict(static=True))
    cols_blk: int = dataclasses.field(metadata=dict(static=True))
    grid: Tuple[int, int] = dataclasses.field(metadata=dict(static=True))


def shard_csr_2d(csr: CSRMatrix, mesh: Mesh) -> ShardedCSR2D:
    """Repack a CSR into (row-block, col-block) cells for a 2-D mesh."""
    R, C = mesh.devices.shape
    nrows, ncols = csr.shape
    rows_blk = _round_up(nrows, R) // R
    cols_blk = _round_up(ncols, C) // C

    row_ptr = np.asarray(csr.row_ptr)
    col = np.asarray(csr.col_ind)[: csr.nnz].astype(np.int64)
    val = np.asarray(csr.vals)[: csr.nnz]
    row = _csr_entry_rows(csr, row_ptr)

    bi = row // rows_blk
    bj = col // cols_blk
    cell = bi * C + bj
    order = np.argsort(cell, kind="stable")  # row-sorted within cell
    counts = np.bincount(cell, minlength=R * C)
    nnz_blk = max(_round_up(int(counts.max()), 8), 8)

    vals_b = np.zeros((R * C, nnz_blk), dtype=val.dtype)
    lcols_b = np.zeros((R * C, nnz_blk), dtype=np.int32)
    lrows_b = np.full((R * C, nnz_blk), rows_blk, dtype=np.int32)
    starts = np.concatenate([[0], np.cumsum(counts)])
    for k in range(R * C):
        sel = order[starts[k]: starts[k + 1]]
        w = len(sel)
        vals_b[k, :w] = val[sel]
        lcols_b[k, :w] = col[sel] - (k % C) * cols_blk
        lrows_b[k, :w] = row[sel] - (k // C) * rows_blk

    spec = NamedSharding(mesh, P(DPR_AXIS, DPC_AXIS, None))
    shape3 = (R, C, nnz_blk)
    return ShardedCSR2D(
        vals=jax.device_put(jnp.asarray(vals_b).reshape(shape3), spec),
        local_cols=jax.device_put(jnp.asarray(lcols_b).reshape(shape3), spec),
        local_rows=jax.device_put(jnp.asarray(lrows_b).reshape(shape3), spec),
        shape=csr.shape,
        nnz=csr.nnz,
        rows_blk=rows_blk,
        cols_blk=cols_blk,
        grid=(R, C),
    )


@partial(jax.jit, static_argnames=("mesh",))
def spmv_csr_2d(sharded: ShardedCSR2D, x: jax.Array, mesh: Mesh) -> jax.Array:
    """y = A·x on the 2-D sharding; x sharded by column block.

    Per device: gather from the local 1/C of x, sorted segment-sum into
    the local row block, ``psum`` partials along dpc, ordered
    ``all_gather`` along dpr. The result is fully replicated.
    """
    R, C = sharded.grid
    rows_blk = sharded.rows_blk
    npad = C * sharded.cols_blk
    if x.shape[0] < npad:
        x = jnp.pad(x, (0, npad - x.shape[0]))
    x_blocks = x.reshape(C, sharded.cols_blk)

    def local(vals, lcols, lrows, xb):
        prod = vals[0, 0] * xb[0][lcols[0, 0]]
        y_part = jax.ops.segment_sum(
            prod, lrows[0, 0], num_segments=rows_blk,
            indices_are_sorted=True,
        )
        y_blk = jax.lax.psum(y_part, DPC_AXIS)
        return jax.lax.all_gather(y_blk, DPR_AXIS, tiled=True)

    y = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(
            P(DPR_AXIS, DPC_AXIS, None),
            P(DPR_AXIS, DPC_AXIS, None),
            P(DPR_AXIS, DPC_AXIS, None),
            P(DPC_AXIS, None),  # x: sharded along columns, dpr-replicated
        ),
        out_specs=P(),
        check_vma=False,  # collectives produce the replicated result
    )(sharded.vals, sharded.local_cols, sharded.local_rows, x_blocks)
    return y[: sharded.shape[0]]


@partial(jax.jit, static_argnames=("mesh",))
def spmm_csr_2d(sharded: ShardedCSR2D, x: jax.Array, mesh: Mesh) -> jax.Array:
    """Y = A·X on the 2-D sharding; X row-sharded by column block.

    The distributed-GCN hot op at 2-D scale: each device holds only its
    (1/C of X rows, k) feature slab — together with the column-sharded
    x-vector path this lifts the feature-matrix footprint cap of 1-D
    DP. Same collective pattern as :func:`spmv_csr_2d`.
    """
    R, C = sharded.grid
    rows_blk = sharded.rows_blk
    k = x.shape[1]
    npad = C * sharded.cols_blk
    if x.shape[0] < npad:
        x = jnp.pad(x, ((0, npad - x.shape[0]), (0, 0)))
    x_blocks = x.reshape(C, sharded.cols_blk, k)

    def local(vals, lcols, lrows, xb):
        prod = vals[0, 0][:, None] * xb[0][lcols[0, 0], :]
        y_part = jax.ops.segment_sum(
            prod, lrows[0, 0], num_segments=rows_blk,
            indices_are_sorted=True,
        )
        y_blk = jax.lax.psum(y_part, DPC_AXIS)
        return jax.lax.all_gather(y_blk, DPR_AXIS, tiled=True)

    y = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(
            P(DPR_AXIS, DPC_AXIS, None),
            P(DPR_AXIS, DPC_AXIS, None),
            P(DPR_AXIS, DPC_AXIS, None),
            P(DPC_AXIS, None, None),
        ),
        out_specs=P(),
        check_vma=False,
    )(sharded.vals, sharded.local_cols, sharded.local_rows, x_blocks)
    return y[: sharded.shape[0]]
