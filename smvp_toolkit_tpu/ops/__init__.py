"""SpMV compute kernels: jitted XLA implementations.

Replaces the reference's C pointer-chasing hot loops (CSR
main-cli.c:410-416, TJDS main-cli.c:1013-1020) with vectorized on-device
programs.
"""

from smvp_toolkit_tpu.ops.spmv_xla import (
    spmv_coo,
    spmv_csr,
    spmv_csr_cumsum,
    spmv_tjds,
    spmm_csr,
    spmm_tjds,
)
from smvp_toolkit_tpu.ops.spmv_cusparse import csr_spmv_for, spmv_csr_cusparse
from smvp_toolkit_tpu.ops.spmv_cisr import spmv_cisr, CisrSpMV
from smvp_toolkit_tpu.ops.algebra import (
    transpose,
    diagonal,
    row_sums,
    col_sums,
    scale,
    add,
    matmul,
)
from smvp_toolkit_tpu.ops.ilu import (
    ilu0,
    ic0,
    trisolve_neumann,
    ILU0Factors,
    IC0Factors,
)

__all__ = [
    "spmv_coo",
    "spmv_csr",
    "spmv_csr_cumsum",
    "spmv_csr_cusparse",
    "csr_spmv_for",
    "spmv_tjds",
    "spmv_cisr",
    "CisrSpMV",
    "spmm_csr",
    "spmm_tjds",
    "transpose",
    "diagonal",
    "row_sums",
    "col_sums",
    "scale",
    "add",
    "matmul",
    "ilu0",
    "ic0",
    "trisolve_neumann",
    "ILU0Factors",
    "IC0Factors",
]
