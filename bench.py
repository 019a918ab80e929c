#!/usr/bin/env python
"""Headline benchmark: CSR SpMV on the GPU, through the route
``ops.csr_spmv_for`` picks there (the CLI's ``--kernel auto``).

Matrix: ``synth:2000000:24000000``, the banded matrix of
``chip_smoke.py`` phase 1 (about 300 MB of CSR by ``spmv_bytes_csr``,
six times the H100's 50 MB L2). Timing: warmed windows of back-to-back
calls, each closed by ``block_until_ready``; the median window gives
the rate. y is checked against scipy in float64 before timing
(``benchmarks/spmv_routes.py`` times every route with the same code).

Prints ONE JSON line with the device (platform, ``device_kind``, device
count, ``nvidia-smi`` name and power limit), nnz/s, effective GB/s and
``roofline_frac``. Exits non-zero off the GPU.
"""

from __future__ import annotations

import json
import sys

# The one measurement matrix: ``benchmarks/spmv_routes.py`` and
# ``chip_smoke.py`` phase 1 import it from here.
SPEC = "synth:2000000:24000000"
WINDOWS = 7
CALLS = 20
# f32 rows of about 12 products in another order than scipy's.
TOL = 1e-5


def prepare(spec: str = SPEC):
    """``(coo, csr, a64, x_host)``: the matrix on the device, its float64
    scipy twin and a seeded x."""
    import numpy as np
    import scipy.sparse as sp

    from smvp_toolkit_tpu.formats.csr import csr_encode
    from smvp_toolkit_tpu.utils.synth import parse_synth_spec

    coo = parse_synth_spec(spec).pad(128)
    r, c, v = coo.to_numpy()
    a64 = sp.csr_matrix((v.astype(np.float64), (r, c)), shape=coo.shape)
    x_host = np.random.default_rng(0).standard_normal(coo.shape[1])
    return coo, csr_encode(coo), a64, x_host


def time_spmv(spmv, coo, csr, a64, x_host) -> dict:
    """Check ``spmv`` against scipy, then time it: ``WINDOWS`` warmed
    windows of ``CALLS`` back-to-back calls, each closed by
    ``block_until_ready``."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from smvp_toolkit_tpu.bench import time_fn
    from smvp_toolkit_tpu.bench.roofline import (
        roofline_fraction,
        spmv_bytes_csr,
    )

    x = jnp.asarray(x_host, jnp.float32)
    y_ref = a64 @ x_host
    y = np.asarray(spmv(csr, x), np.float64)
    err = float(np.abs(y - y_ref).max() / np.abs(y_ref).max())
    stats = time_fn(lambda: spmv(csr, x), iterations=WINDOWS, warmup=2,
                    inner=CALLS)
    ms = float(np.median(stats.times_ms))
    gbs = spmv_bytes_csr(coo.nnz, coo.shape[0], 4) / (ms * 1e-3) / 1e9
    device = jax.devices()[0]
    return {
        "rows": coo.shape[0],
        "nnz": coo.nnz,
        "median_ms": ms,
        "window_ms": [float(t) for t in stats.times_ms],
        "nnz_per_s": coo.nnz / (ms * 1e-3),
        "eff_gb_s": gbs,
        "roofline_frac": roofline_fraction(gbs, device),
        "max_rel_err": err,
        "within_tol": err <= TOL,
        "platform": device.platform,
        "device_kind": device.device_kind,
        "device_count": len(jax.devices()),
    }


def measure(spec: str = SPEC) -> dict:
    """Time the ``--kernel auto`` CSR route on ``spec``; one record."""
    import jax

    from smvp_toolkit_tpu.ops import csr_spmv_for

    coo, csr, a64, x_host = prepare(spec)
    kernel, spmv = csr_spmv_for(jax.devices()[0].platform, coo.dtype)
    rec = time_spmv(spmv, coo, csr, a64, x_host)
    if not rec["within_tol"]:
        raise AssertionError(
            f"max|dy|/max|y| = {rec['max_rel_err']:.3e} exceeds {TOL}")
    return {"metric": "csr_spmv", "matrix": spec, "kernel": kernel, **rec}


def main() -> int:
    from smvp_toolkit_tpu.bench.device import (
        NoGPUError,
        nvidia_smi_name_power,
        require_gpu,
    )
    from smvp_toolkit_tpu.utils.compile_cache import configure_compile_cache

    try:
        require_gpu()
    except NoGPUError as e:
        print(f"bench: {e}", file=sys.stderr)
        return 1
    configure_compile_cache()
    rec = measure()
    rec["card"] = nvidia_smi_name_power()
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
