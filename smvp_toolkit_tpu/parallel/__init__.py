"""Data-parallel SpMV over a device mesh (multi-chip / multi-host).

The reference has zero parallelism (SURVEY.md §2: one POSIX thread, no
MPI/OpenMP/SIMD); this subsystem is the new capability demanded by the
north star: CSR row-block sharding and TJDS nnz-stripe sharding across a
``jax.sharding.Mesh``, dense x replicated, partial y reassembled in matrix
order (ordered ``all_gather`` for row blocks, ``psum`` for stripes) — all
collectives are XLA's (NCCL on the GPU), none hand-written.
"""

from smvp_toolkit_tpu.parallel.mesh import (
    make_mesh,
    distributed_init,
    device_count,
)
from smvp_toolkit_tpu.parallel.spmv_dist import (
    ShardedCSR,
    ShardedTJDS,
    shard_csr,
    shard_tjds,
    spmv_csr_sharded,
    spmm_csr_sharded,
    spmv_tjds_sharded,
    shard_and_bench,
)
from smvp_toolkit_tpu.parallel.spmv_2d import (
    ShardedCSR2D,
    make_mesh_2d,
    shard_csr_2d,
    spmv_csr_2d,
    spmm_csr_2d,
)

__all__ = [
    "make_mesh",
    "distributed_init",
    "device_count",
    "ShardedCSR",
    "ShardedTJDS",
    "shard_csr",
    "shard_tjds",
    "spmv_csr_sharded",
    "spmm_csr_sharded",
    "spmv_tjds_sharded",
    "shard_and_bench",
    "ShardedCSR2D",
    "make_mesh_2d",
    "shard_csr_2d",
    "spmv_csr_2d",
    "spmm_csr_2d",
]
