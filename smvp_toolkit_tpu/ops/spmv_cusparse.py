"""CSR SpMV through cuSPARSE — a library kernel, not one of this repository.

``jax.experimental.sparse`` lowers its CSR matvec primitive to cuSPARSE
on CUDA, and to a generic gather + scatter-add elsewhere. On the H100 it
is the fastest route that keeps f32 accuracy (``benchmarks/spmv_routes.py``
times it against the XLA kernels of ``spmv_xla``), so :func:`csr_spmv_for`
picks it on a GPU; the CLI's ``--kernel auto`` and ``bench.py`` take that
choice. The solvers in ``models`` default to ``spmv_csr``; pass
``spmv=csr_spmv_for(platform, dtype)[1]`` to run them on this route.
Autodiff follows the primitive's own rules: d/dx is the transposed
product (cuSPARSE again), d/dvals is ``g[row] * x[col]``.
"""

from __future__ import annotations

from typing import Callable, Tuple

import jax
import jax.numpy as jnp
from jax.experimental import sparse as jsparse

from smvp_toolkit_tpu.formats.csr import CSRMatrix
from smvp_toolkit_tpu.ops.spmv_xla import spmv_csr

__all__ = ["CUSPARSE_DTYPES", "csr_spmv_for", "spmv_csr_cusparse"]

# Value dtypes cuSPARSE takes. For any other JAX would warn and lower the
# generic kernel instead; this module refuses them.
CUSPARSE_DTYPES = tuple(
    jnp.dtype(t) for t in (jnp.float32, jnp.float64, jnp.complex64,
                           jnp.complex128)
)


@jax.jit
def spmv_csr_cusparse(csr: CSRMatrix, x: jax.Array) -> jax.Array:
    """y = A·x with cuSPARSE's CSR SpMV (library kernel).

    Only the true ``nnz`` entries are handed over: padded tails beyond
    ``row_ptr[-1]`` are sliced off so the library sees a consistent nnz.
    """
    if jnp.dtype(csr.vals.dtype) not in CUSPARSE_DTYPES:
        raise TypeError(
            f"cuSPARSE SpMV takes {[str(t) for t in CUSPARSE_DTYPES]}, "
            f"not {csr.vals.dtype}; use ops.spmv_csr"
        )
    n = csr.nnz
    mat = jsparse.CSR(
        (csr.vals[:n], csr.col_ind[:n], csr.row_ptr), shape=csr.shape
    )
    return jsparse.csr_matvec(mat, x.astype(csr.vals.dtype))


def csr_spmv_for(platform: str, dtype) -> Tuple[str, Callable]:
    """``(label, spmv)``: the CSR route for ``platform`` and value ``dtype``.

    On a GPU the cuSPARSE library kernel for the dtypes it takes, the
    fastest accurate CSR route measured there; the XLA gather +
    segment-sum kernel everywhere else.
    """
    if platform == "gpu" and jnp.dtype(dtype) in CUSPARSE_DTYPES:
        return "cusparse", spmv_csr_cusparse
    return "xla", spmv_csr
