"""Sharded SpMV: CSR row blocks and TJDS nnz stripes under ``shard_map``.

Sharding designs (SURVEY.md §2 "Parallelism" plan):

* **CSR row-block DP** — rows are split into ``n`` contiguous blocks, one
  per device; each block's nonzeros are repacked and padded to the max
  block nnz (static shapes across shards). x is replicated; each device
  computes its y block locally with a sorted segment-sum; the global y is
  the ordered concatenation (an ``all_gather`` along the dp axis when a
  replicated result is wanted). Uneven row blocks are handled by padding
  rows to a block multiple and slicing after gather (SURVEY.md §7 hard
  part (d)).

* **TJDS nnz-stripe DP** — the packed (diagonal-major) entry stream is cut
  into ``n`` equal contiguous stripes; each device segment-sums its stripe
  into a full-length partial y, and a ``psum`` over the dp axis reduces
  partials. x is replicated and pre-permuted; the per-entry x position
  (``offsets``) ships with each stripe, so stripes keep the gather-free
  contiguous x reads.
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
from smvp_toolkit_tpu.formats.tjds import TJDSMatrix
from smvp_toolkit_tpu.parallel.mesh import DP_AXIS, make_mesh

__all__ = [
    "ShardedCSR",
    "ShardedTJDS",
    "shard_csr",
    "shard_tjds",
    "spmv_csr_sharded",
    "spmm_csr_sharded",
    "spmv_tjds_sharded",
    "shard_and_bench",
]


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _csr_entry_rows(csr: CSRMatrix, row_ptr: np.ndarray) -> np.ndarray:
    """Global row id per true entry (shared by all CSR sharders).

    Reuses the encoder's cached device ``row_ids`` when present; falls
    back to the row_ptr prefix search.
    """
    if csr.row_ids is not None:
        return np.asarray(csr.row_ids)[: csr.nnz].astype(np.int64)
    return np.searchsorted(row_ptr, np.arange(csr.nnz), side="right") - 1


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ShardedCSR:
    """CSR split into per-device contiguous row blocks (leading dim = shard).

    ``row_starts`` holds each block's first global row (static host
    metadata — block boundaries are encode-time decisions); blocks may
    be uneven when nnz-balanced, padded to ``rows_per_shard`` rows and a
    common nnz width.
    """

    vals: jax.Array  # dtype[n, nnz_blk]
    col_ind: jax.Array  # int32[n, nnz_blk]
    local_rows: jax.Array  # int32[n, nnz_blk] (row - block_start; pad=rows_blk)
    shape: Tuple[int, int] = dataclasses.field(metadata=dict(static=True))
    nnz: int = dataclasses.field(metadata=dict(static=True))
    rows_per_shard: int = dataclasses.field(metadata=dict(static=True))
    n_shards: int = dataclasses.field(metadata=dict(static=True))
    row_starts: Tuple[int, ...] = dataclasses.field(
        default=(), metadata=dict(static=True)
    )
    # Per-block first CSR entry index (static, encode-time). Lets
    # `with_vals` rebuild the slab from live values inside a trace.
    nnz_starts: Tuple[int, ...] = dataclasses.field(
        default=(), metadata=dict(static=True)
    )

    def with_vals(self, ev: jax.Array) -> "ShardedCSR":
        """Rebuild the per-shard values slab from CSR-entry-order values.

        ``ev`` is a vector in the encoded CSR's entry order (at least
        ``nnz`` long, e.g. ``CSRMatrix.vals``); block boundaries are
        static, so this is a stack of static slices — fully
        differentiable, which is what lets DISTRIBUTED edge-weight
        training drive the sharded SpMM from one live parameter vector
        (models/graph.gcn_train_step_edges with an injected spmm).
        """
        if not self.nnz_starts:
            raise ValueError(
                "with_vals needs nnz_starts metadata (re-shard with "
                "this version's shard_csr)"
            )
        ends = self.nnz_starts[1:] + (self.nnz,)
        nnz_blk = int(self.vals.shape[1])
        blocks = []
        for s, e in zip(self.nnz_starts, ends):
            blocks.append(jnp.pad(ev[s:e], (0, nnz_blk - (e - s))))
        return dataclasses.replace(
            self, vals=jnp.stack(blocks).astype(self.vals.dtype)
        )

    def block_rows(self) -> Tuple[int, ...]:
        """True (unpadded) row count of each block."""
        starts = self.row_starts or tuple(
            min(k * self.rows_per_shard, self.shape[0])
            for k in range(self.n_shards)
        )
        ends = starts[1:] + (self.shape[0],)
        return tuple(e - s for s, e in zip(starts, ends))


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ShardedTJDS:
    """TJDS packed entries split into equal contiguous nnz stripes."""

    vals: jax.Array  # dtype[n, nnz_blk]
    row_ind: jax.Array  # int32[n, nnz_blk] (pad -> nrows sentinel)
    offsets: jax.Array  # int32[n, nnz_blk] (position within diagonal)
    perm: jax.Array  # int32[ncols]
    shape: Tuple[int, int] = dataclasses.field(metadata=dict(static=True))
    nnz: int = dataclasses.field(metadata=dict(static=True))
    n_shards: int = dataclasses.field(metadata=dict(static=True))


# ---------------------------------------------------------------------------
# Sharding (host-side repack; encode-time cost, not per-iteration)
# ---------------------------------------------------------------------------


def shard_csr(
    csr: CSRMatrix, mesh: Mesh, *, balance: str = "rows"
) -> ShardedCSR:
    """Repack a CSR into per-device contiguous row blocks.

    ``balance="rows"`` splits rows evenly (the simple default);
    ``balance="nnz"`` places block boundaries at equal-nnz quantiles of
    ``row_ptr`` so skewed matrices (power-law row lengths) load devices
    evenly — with even-rows splitting, one hub-heavy block otherwise
    carries most of the work and sets the step time. Blocks stay
    contiguous in row order either way, so the gathered y needs no
    permutation.
    """
    n = mesh.devices.size
    nrows = csr.shape[0]
    row_ptr = np.asarray(csr.row_ptr)

    if balance == "nnz":
        targets = (np.arange(1, n) * csr.nnz) // n
        cuts = np.searchsorted(row_ptr, targets, side="left")
        row_starts = np.concatenate([[0], cuts, [nrows]]).astype(np.int64)
        np.maximum.accumulate(row_starts, out=row_starts)  # nondecreasing
    elif balance == "rows":
        blk = _round_up(max(nrows, 1), n) // n
        row_starts = np.minimum(np.arange(n + 1) * blk, nrows)
    else:
        raise ValueError(f"balance must be 'rows' or 'nnz', got {balance!r}")

    rows_blk = max(int(np.diff(row_starts).max()), 1)

    col = np.asarray(csr.col_ind)[: csr.nnz]
    val = np.asarray(csr.vals)[: csr.nnz]

    # Entry counts per block → common padded width.
    starts = row_ptr[row_starts[:-1]]
    ends = row_ptr[row_starts[1:]]
    widths = ends - starts
    nnz_blk = max(_round_up(int(widths.max()) if n else 1, 8), 8)

    vals_b = np.zeros((n, nnz_blk), dtype=val.dtype)
    cols_b = np.zeros((n, nnz_blk), dtype=np.int32)
    lrows_b = np.full((n, nnz_blk), rows_blk, dtype=np.int32)  # pad sentinel

    grow = _csr_entry_rows(csr, row_ptr)
    for k in range(n):
        s, e = int(starts[k]), int(ends[k])
        w = e - s
        vals_b[k, :w] = val[s:e]
        cols_b[k, :w] = col[s:e]
        lrows_b[k, :w] = grow[s:e] - int(row_starts[k])

    spec_blk = NamedSharding(mesh, P(DP_AXIS, None))
    return ShardedCSR(
        vals=jax.device_put(jnp.asarray(vals_b), spec_blk),
        col_ind=jax.device_put(jnp.asarray(cols_b), spec_blk),
        local_rows=jax.device_put(jnp.asarray(lrows_b), spec_blk),
        shape=csr.shape,
        nnz=csr.nnz,
        rows_per_shard=rows_blk,
        n_shards=n,
        row_starts=tuple(int(s) for s in row_starts[:-1]),
        nnz_starts=tuple(int(s) for s in starts),
    )


def shard_tjds(tjds: TJDSMatrix, mesh: Mesh) -> ShardedTJDS:
    """Cut the packed entry stream into equal contiguous nnz stripes."""
    n = mesh.devices.size
    nnz = tjds.nnz
    nnz_blk = max(_round_up(max(nnz, 1), n) // n, 8)

    val = np.asarray(tjds.vals)[:nnz]
    row = np.asarray(tjds.row_ind)[:nnz]
    off = np.asarray(tjds.offsets)[:nnz]

    total = n * nnz_blk
    vals_b = np.zeros(total, dtype=val.dtype)
    rows_b = np.full(total, tjds.shape[0], dtype=np.int32)  # pad sentinel
    offs_b = np.zeros(total, dtype=np.int32)
    vals_b[:nnz] = val
    rows_b[:nnz] = row
    offs_b[:nnz] = off

    spec_blk = NamedSharding(mesh, P(DP_AXIS, None))
    spec_rep = NamedSharding(mesh, P())
    return ShardedTJDS(
        vals=jax.device_put(jnp.asarray(vals_b).reshape(n, nnz_blk), spec_blk),
        row_ind=jax.device_put(jnp.asarray(rows_b).reshape(n, nnz_blk), spec_blk),
        offsets=jax.device_put(jnp.asarray(offs_b).reshape(n, nnz_blk), spec_blk),
        perm=jax.device_put(tjds.perm, spec_rep),
        shape=tjds.shape,
        nnz=nnz,
        n_shards=n,
    )


# ---------------------------------------------------------------------------
# Sharded SpMV
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("mesh", "gather"))
def spmv_csr_sharded(
    sharded: ShardedCSR, x: jax.Array, mesh: Mesh, gather: bool = True
) -> jax.Array:
    """y = A·x with row-block DP; x replicated, y ordered.

    With ``gather=True`` the per-device y blocks are all-gathered inside
    the shard_map (an ordered ``all_gather`` along the dp axis — shard
    order IS matrix row order) and the padded tail sliced off; the result
    is fully replicated, so it is addressable on every process of a
    multi-host run. With ``False`` the result stays sharded as
    (n, rows_per_shard).
    """
    rows_blk = sharded.rows_per_shard

    def local_spmv(vals, cols, lrows, xl):
        prod = vals[0] * xl[cols[0]]
        yblk = jax.ops.segment_sum(
            prod, lrows[0], num_segments=rows_blk, indices_are_sorted=True
        )
        if gather:
            return jax.lax.all_gather(yblk, DP_AXIS, tiled=True)
        return yblk[None, :]

    y_blocks = jax.shard_map(
        local_spmv,
        mesh=mesh,
        in_specs=(P(DP_AXIS, None), P(DP_AXIS, None), P(DP_AXIS, None), P()),
        out_specs=P() if gather else P(DP_AXIS, None),
        # all_gather output IS replicated (every device holds the full,
        # identically-ordered y) but the varying-mesh-axes checker cannot
        # infer that through collectives.
        check_vma=not gather,
    )(sharded.vals, sharded.col_ind, sharded.local_rows, x)
    if gather:
        # Strip per-block row padding (blocks may be uneven when
        # nnz-balanced); block row counts are static, so this is a
        # static concatenation of slices.
        yb = y_blocks.reshape(sharded.n_shards, rows_blk)
        return jnp.concatenate(
            [yb[i, :r] for i, r in enumerate(sharded.block_rows())]
        )
    return y_blocks


@partial(jax.jit, static_argnames=("mesh", "gather"))
def spmm_csr_sharded(
    sharded: ShardedCSR, x: jax.Array, mesh: Mesh, gather: bool = True
) -> jax.Array:
    """Y = A·X for a dense block X (ncols, k) with row-block DP.

    The multi-vector companion to :func:`spmv_csr_sharded` — the hot op
    of data-parallel graph learning (GCN aggregation S·H across chips).
    X is replicated (every device needs arbitrary columns of its block's
    rows); each device segment-sums its row block's (nnz_blk, k)
    products; ``gather=True`` all-gathers the ordered row blocks into a
    replicated (nrows, k), else the result stays sharded as
    (n, rows_per_shard, k).
    """
    rows_blk = sharded.rows_per_shard

    def local_spmm(vals, cols, lrows, xl):
        prod = vals[0][:, None] * xl[cols[0], :]
        yblk = jax.ops.segment_sum(
            prod, lrows[0], num_segments=rows_blk, indices_are_sorted=True
        )
        if gather:
            return jax.lax.all_gather(yblk, DP_AXIS, tiled=True)
        return yblk[None]

    y_blocks = jax.shard_map(
        local_spmm,
        mesh=mesh,
        in_specs=(P(DP_AXIS, None), P(DP_AXIS, None), P(DP_AXIS, None), P()),
        out_specs=P() if gather else P(DP_AXIS, None, None),
        check_vma=not gather,  # see spmv_csr_sharded
    )(sharded.vals, sharded.col_ind, sharded.local_rows, x)
    if gather:
        yb = y_blocks.reshape(sharded.n_shards, rows_blk, x.shape[1])
        return jnp.concatenate(
            [yb[i, :r] for i, r in enumerate(sharded.block_rows())]
        )
    return y_blocks


@partial(jax.jit, static_argnames=("mesh",))
def spmv_tjds_sharded(sharded: ShardedTJDS, x: jax.Array, mesh: Mesh) -> jax.Array:
    """y = A·x with nnz-stripe DP; partial y reduced with psum."""
    nrows = sharded.shape[0]
    xp = x[sharded.perm]

    def local_spmv(vals, rows, offs, xpl):
        prod = vals[0] * xpl[offs[0]]
        y_part = jax.ops.segment_sum(prod, rows[0], num_segments=nrows)
        return jax.lax.psum(y_part, DP_AXIS)

    return jax.shard_map(
        local_spmv,
        mesh=mesh,
        in_specs=(P(DP_AXIS, None), P(DP_AXIS, None), P(DP_AXIS, None), P()),
        out_specs=P(),
    )(sharded.vals, sharded.row_ind, sharded.offsets, xp)


# ---------------------------------------------------------------------------
# CLI helper
# ---------------------------------------------------------------------------


def shard_and_bench(
    alg_name, encoded, x, n_shards, *, iterations=1000, balance="rows",
):
    """Shard an encoded matrix over n devices and benchmark sharded SpMV
    (the segment-sum kernels under ``shard_map``)."""
    from smvp_toolkit_tpu.bench.harness import time_fn

    mesh = make_mesh(n_shards)
    if alg_name == "CSR":
        sharded = shard_csr(encoded, mesh, balance=balance)
        fn = lambda: spmv_csr_sharded(sharded, x, mesh)  # noqa: E731
    elif alg_name == "TJDS":
        sharded = shard_tjds(encoded, mesh)
        fn = lambda: spmv_tjds_sharded(sharded, x, mesh)  # noqa: E731
    else:
        raise ValueError(f"unknown algorithm {alg_name!r}")
    stats = time_fn(fn, iterations=iterations)
    y = np.asarray(fn())
    return stats, y
