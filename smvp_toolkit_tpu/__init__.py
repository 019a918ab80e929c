"""smvp_toolkit_tpu — a sparse-matrix codec + SpMV framework on JAX.

A from-scratch JAX/XLA re-design with the capabilities of the
circletile/smvp-toolkit reference (an ANSI-C MatrixMarket → CSR/TJDS/CISR
encoder + timed SpMV benchmark CLI; see reference main-cli.c):

* MatrixMarket I/O (``smvp_toolkit_tpu.io``) — parse/write ``.mtx`` files
  (reference: mmio/mmio.c).
* Compressed formats (``smvp_toolkit_tpu.formats``) — COO, CSR, TJDS, CISR
  as immutable pytree dataclasses with XLA encode **and decode** kernels
  (reference encodes only: main-cli.c:325-469, 734-1162, 473-729).
* SpMV compute (``smvp_toolkit_tpu.ops``) — jitted XLA kernels (and
  cuSPARSE on a GPU) replacing the C pointer-chasing hot loops
  (reference: main-cli.c:410-416, 1013-1020).
* Data-parallel scaling (``smvp_toolkit_tpu.parallel``) — mesh + shard_map
  row-block / stripe sharding with ordered all-gather (no reference
  equivalent; the reference is single-threaded).
* Benchmark harness + reports (``smvp_toolkit_tpu.bench``) — device-blocked
  timing, stats, GB/s + nnz/s + roofline fraction, reference-compatible
  report files (reference: main-cli.c:87-130, 246-320).
* CLI (``smvp_toolkit_tpu.cli``) — the reference's flag surface with the
  ``--all-algs`` bug fixed (reference: main-cli.c:1219-1481).
"""

__version__ = "0.1.0"

from smvp_toolkit_tpu.formats.coo import COOMatrix
from smvp_toolkit_tpu.formats.csr import CSRMatrix, csr_encode, csr_decode
from smvp_toolkit_tpu.formats.tjds import TJDSMatrix, tjds_encode, tjds_decode
from smvp_toolkit_tpu.formats.cisr import (
    CISRMatrix,
    cisr_encode,
    cisr_decode,
    write_coe,
)
from smvp_toolkit_tpu.io.mtx import read_mtx, write_mtx

__all__ = [
    "COOMatrix",
    "CSRMatrix",
    "csr_encode",
    "csr_decode",
    "TJDSMatrix",
    "tjds_encode",
    "tjds_decode",
    "CISRMatrix",
    "cisr_encode",
    "cisr_decode",
    "write_coe",
    "read_mtx",
    "write_mtx",
    "__version__",
]
