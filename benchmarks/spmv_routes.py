#!/usr/bin/env python
"""Time the device SpMV routes a GPU can take, on one generated matrix.

Routes, all on the same CSR encoding of ``bench.SPEC`` (a banded
matrix, the one ``bench.py`` and ``chip_smoke.py`` phase 1 use):

* ``spmv_csr`` — gather, multiply, sorted segment-sum (XLA);
* ``spmv_csr_cumsum`` — gather, multiply, prefix sum, two gathers (XLA);
* ``csr_matvec`` — ``ops.spmv_csr_cusparse``: ``jax.experimental.sparse``'s
  CSR matvec, which JAX lowers to cuSPARSE on CUDA — a library kernel,
  not one of this repository. Its generic-lowering warning is an error
  here.

Each route is checked and timed by ``bench.time_spmv``: y against a
float64 scipy product (``within_tol``: max|dy| at most 1e-5 of max|y|;
a route that misses it cannot be the default), then ``bench.WINDOWS``
warmed windows of ``bench.CALLS`` back-to-back calls, each closed by
``block_until_ready``; the median window gives the rate.

Usage: python benchmarks/spmv_routes.py
Prints the card line and one JSON line per route; exits non-zero off
the GPU.
"""

from __future__ import annotations

import json
import os
import sys
import warnings

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def routes():
    """``{name: fn(csr, x) -> y}`` for every route."""
    from smvp_toolkit_tpu.ops import (
        spmv_csr,
        spmv_csr_cumsum,
        spmv_csr_cusparse,
    )

    return {
        "spmv_csr": spmv_csr,
        "spmv_csr_cumsum": spmv_csr_cumsum,
        "csr_matvec": spmv_csr_cusparse,
    }


def main() -> int:
    from smvp_toolkit_tpu.bench.device import (
        NoGPUError,
        nvidia_smi_name_power,
        require_gpu,
    )

    try:
        require_gpu()
    except NoGPUError as e:
        print(f"spmv_routes: {e}", file=sys.stderr)
        return 1

    from jax.experimental.sparse import CuSparseEfficiencyWarning

    import bench
    from smvp_toolkit_tpu.utils.compile_cache import configure_compile_cache

    configure_compile_cache()
    card = nvidia_smi_name_power()
    print(f"card: {card}", flush=True)
    prepared = bench.prepare(bench.SPEC)
    for name, fn in routes().items():
        with warnings.catch_warnings():
            warnings.simplefilter("error", CuSparseEfficiencyWarning)
            rec = bench.time_spmv(fn, *prepared)
        print(json.dumps({"route": name, **rec, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
