#!/usr/bin/env python
"""Full benchmark suite: every sample matrix x {CSR, TJDS} x kernels,
plus the synthetic 10M-nnz scaling input (BASELINE.json configs).

The sample matrices are the generated stand-ins of the reference's
sample data (``utils.synth.sample_matrix``: same shape, nnz and type
code). Emits one JSON line per (matrix, algorithm, kernel) with timing
and roofline metrics, each naming the device it ran on.

Usage: python benchmarks/run_all.py [--quick] [--out results.jsonl]
       [--kernels xla,cusparse,native] [--matrices ibm32,memplus]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

SAMPLES = ["ibm32", "curtis54", "pdp08-pg4", "memplus", "pwt"]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true", help="small iteration counts")
    ap.add_argument("--out", default=None, help="also append JSONL here")
    ap.add_argument("--skip-synth", action="store_true")
    ap.add_argument("--kernels", default="xla,cusparse")
    ap.add_argument(
        "--matrices",
        default=None,
        help="comma-separated subset of sample matrices (default: all)",
    )
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np

    from smvp_toolkit_tpu.bench import (
        bench_spmv_fused,
        hbm_bandwidth_gbs,
        spmv_bytes_csr,
        spmv_bytes_tjds,
    )
    from smvp_toolkit_tpu.formats.csr import csr_encode
    from smvp_toolkit_tpu.formats.tjds import tjds_encode
    from smvp_toolkit_tpu.ops import spmv_csr, spmv_csr_cusparse, spmv_tjds
    from smvp_toolkit_tpu.utils.synth import sample_matrix, synth_banded

    device = jax.devices()[0]
    iters = 50 if args.quick else 200
    kernels = args.kernels.split(",")
    results = []

    def record(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        results.append(rec)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")

    wanted = args.matrices.split(",") if args.matrices else SAMPLES
    matrices = {name: sample_matrix(name).pad(512) for name in wanted}
    if not args.skip_synth:
        matrices["synth-10M"] = synth_banded(
            1_000_000, nnz_per_row=10, bandwidth=256, seed=0
        ).pad(512)
        # goodwin.mtx (7320^2, 324784 nnz, strongly nonuniform rows) is
        # not distributed either; a power-law matrix at its shape stands
        # in for the BASELINE.json "jagged-diagonal pack with nonuniform
        # row lengths" config.
        from smvp_toolkit_tpu.utils.synth import synth_powerlaw

        matrices["goodwin-surrogate"] = synth_powerlaw(
            7320, nnz=324784, alpha=1.2, seed=3
        ).pad(512)

    import time as _time

    from smvp_toolkit_tpu.formats.csr import csr_decode
    from smvp_toolkit_tpu.formats.tjds import tjds_decode

    for name, coo in matrices.items():
        x = jnp.ones((coo.shape[1],), jnp.float32)
        r, c, v = coo.to_numpy()
        y_ref = np.zeros(coo.shape[0])
        np.add.at(y_ref, r, v.astype(np.float64))
        scale = np.abs(y_ref).max() + 1e-30

        # Encode throughput + decode bit-exactness (BASELINE.json metric:
        # "encode MB/s; decode bit-exactness").
        coo_bytes = coo.nnz * 12  # 2 x int32 + f32 per entry
        for alg, enc_fn, dec_fn in [
            ("CSR", csr_encode, csr_decode),
            ("TJDS", tjds_encode, tjds_decode),
        ]:
            try:
                jax.block_until_ready(jax.tree_util.tree_leaves(enc_fn(coo)))
                t0 = _time.perf_counter()
                reps = 3
                for _ in range(reps):
                    enc = enc_fn(coo)
                    jax.block_until_ready(jax.tree_util.tree_leaves(enc))
                dt = (_time.perf_counter() - t0) / reps
                dec = dec_fn(enc).canonical_order()
                canon = coo.canonical_order()
                dr, dc, dv = dec.to_numpy()
                cr, cc, cv = canon.to_numpy()
                exact = bool(
                    np.array_equal(dr, cr)
                    and np.array_equal(dc, cc)
                    and np.array_equal(
                        np.asarray(dv).view(np.uint32),
                        np.asarray(cv).view(np.uint32),
                    )
                )
                record({
                    "matrix": name,
                    "alg": alg,
                    "op": "encode+decode",
                    "encode_ms": round(dt * 1e3, 3),
                    "encode_mb_s": round(coo_bytes / dt / 1e6, 1),
                    "decode_bit_exact": exact,
                })
            except Exception as e:  # pragma: no cover
                record({"matrix": name, "alg": alg, "op": "encode",
                        "error": str(e)[:200]})

        # CISR: schedule encode + the schedule-consuming SpMV kernel
        # (capability the reference never implemented; skip the 10M synth
        # where the beat-count explodes the schedule).
        if name != "synth-10M":
            try:
                from smvp_toolkit_tpu.formats.cisr import (
                    cisr_decode,
                    cisr_encode,
                )
                from smvp_toolkit_tpu.ops import spmv_cisr

                t0 = _time.perf_counter()
                cisr = cisr_encode(coo, slot_count=16)
                dt = _time.perf_counter() - t0
                dec = cisr_decode(cisr).canonical_order()
                dr, dc, dv = dec.to_numpy()
                cr, cc, cv = coo.canonical_order().to_numpy()
                exact = bool(
                    np.array_equal(dr, cr) and np.array_equal(dc, cc)
                )
                y = np.asarray(spmv_cisr(cisr, x)).astype(np.float64)
                err = float(np.abs(y - y_ref).max() / scale)
                stats = bench_spmv_fused(
                    spmv_cisr, cisr, x, iterations=iters, repeats=3
                )
                record({
                    "matrix": name, "alg": "CISR", "kernel": "xla",
                    "nnz": coo.nnz, "encode_ms": round(dt * 1e3, 3),
                    "decode_index_exact": exact,
                    "avg_ms": round(stats.avg_ms, 6),
                    "gnnz_per_s": round(
                        stats.nnz_per_s(coo.nnz) / 1e9, 3
                    ),
                    "rel_err": err,
                    "device": device.device_kind,
                })
            except Exception as e:  # pragma: no cover
                record({"matrix": name, "alg": "CISR", "op": "bench",
                        "error": str(e)[:200]})

        encs = {
            "CSR": (csr_encode(coo),
                    {"xla": spmv_csr, "cusparse": spmv_csr_cusparse},
                    spmv_bytes_csr(coo.nnz, coo.shape[0])),
        }
        if name != "synth-10M":
            tj = tjds_encode(coo)
            encs["TJDS"] = (tj, {"xla": spmv_tjds},
                            spmv_bytes_tjds(coo.nnz, coo.shape[0],
                                            int(tj.num_diags)))

        for alg, (enc, fns, bytes_per) in encs.items():
            for kernel in kernels:
                if kernel == "native":
                    try:
                        from smvp_toolkit_tpu.ops.spmv_native import (
                            NativeCsrSpMV,
                            NativeTjdsSpMV,
                            native_spmv_available,
                        )
                    except ImportError:
                        continue
                    if not native_spmv_available():
                        continue
                    op = (NativeCsrSpMV if alg == "CSR" else NativeTjdsSpMV)(enc)
                    xn = np.ones(coo.shape[1], dtype=np.float32)
                    y = op(xn).astype(np.float64)
                    err = float(np.abs(y - y_ref).max() / scale)
                    if err > 1e-3:
                        record({"matrix": name, "alg": alg, "kernel": kernel,
                                "error": f"wrong result ({err:.2e})"})
                        continue
                    import time as _t2

                    op(xn, iterations=20)
                    t0 = _t2.perf_counter()
                    op(xn, iterations=iters)
                    dt_ms = (_t2.perf_counter() - t0) / iters * 1e3
                    nnzs = coo.nnz / (dt_ms * 1e-3)
                    record({
                        "matrix": name, "alg": alg,
                        "kernel": f"native-{op.threads}t",
                        "nnz": coo.nnz, "avg_ms": round(dt_ms, 6),
                        "gnnz_per_s": round(nnzs / 1e9, 3),
                        "rel_err": err, "device": "cpu-native",
                    })
                    continue
                fn = fns.get(kernel)
                if fn is None:
                    continue  # no such route for this format
                try:
                    y = np.asarray(fn(enc, x)).astype(np.float64)
                    err = float(np.abs(y - y_ref).max() / scale)
                    if err > 1e-3:
                        record({"matrix": name, "alg": alg, "kernel": kernel,
                                "error": f"wrong result (rel err {err:.2e})"})
                        continue
                    stats = bench_spmv_fused(
                        fn, enc, x, iterations=iters, repeats=3
                    )
                    nnzs = stats.nnz_per_s(coo.nnz)
                    gbs = stats.gb_per_s(bytes_per)
                    rec = {
                        "matrix": name,
                        "alg": alg,
                        "kernel": kernel,
                        "nnz": coo.nnz,
                        "avg_ms": round(stats.avg_ms, 6),
                        "gnnz_per_s": round(nnzs / 1e9, 3),
                        "eff_gb_s": round(gbs, 2),
                        "roofline_frac": round(
                            gbs / hbm_bandwidth_gbs(device), 5
                        ),
                        "rel_err": err,
                        "device": device.device_kind,
                        "platform": device.platform,
                    }
                    record(rec)
                except Exception as e:  # pragma: no cover
                    record({"matrix": name, "alg": alg, "kernel": kernel,
                            "error": str(e)[:200]})

        # Data-parallel row (BASELINE.json: "memplus row-block sharded",
        # "pwt + synth multi-host DP") whenever >1 device is visible
        # (real chips, or the CPU-simulated mesh in CI).
        n_dev = len(jax.devices())
        if n_dev > 1 and name in ("memplus", "pwt", "synth-10M"):
            try:
                from smvp_toolkit_tpu.parallel import shard_and_bench

                stats, y = shard_and_bench(
                    "CSR", encs["CSR"][0], x, n_dev, iterations=iters
                )
                err = float(
                    np.abs(np.asarray(y, dtype=np.float64) - y_ref).max()
                    / scale
                )
                record({
                    "matrix": name, "alg": "CSR",
                    "kernel": f"xla-sharded-{n_dev}dev",
                    "nnz": coo.nnz,
                    "avg_ms": round(stats.avg_ms, 6),
                    "gnnz_per_s": round(
                        stats.nnz_per_s(coo.nnz) / 1e9, 3
                    ),
                    "rel_err": err,
                    "device": device.device_kind,
                })
            except Exception as e:  # pragma: no cover
                record({"matrix": name, "alg": "CSR", "kernel": "sharded",
                        "error": str(e)[:200]})
    return 0


if __name__ == "__main__":
    sys.exit(main())
