"""Command-line interface — the reference CLI surface on a JAX engine.

Flag parity with the reference popt table (main-cli.c:1243-1252):
``--all-algs/-a``, ``--csr/-c``, ``--tjds/-t``, ``--cisr-gen/-g``,
``-n/--iter``, ``-s/--slots``, ``-d/--dir``, positional ``file.mtx``.
Validation matches main-cli.c:1274-1386: ``--all-algs`` is exclusive with
individual algorithm flags; iteration/slot counts must be positive; the
report dir must exist.

Intentional fix: ``--all-algs`` actually runs every algorithm — in the
reference it is a no-op because ``ALG_ALL`` shares no bits with the
per-algorithm masks (SURVEY.md §B1).

New flags (capabilities the reference lacks): ``--kernel`` (xla /
native C++ / df64), ``--dtype``, ``--expand-symmetry``,
``--decode-check``, ``--coe-out``, ``--shards``, ``--shard-balance``,
``--fused``, ``--debug``, ``--lut-out``, ``--save-encoded``,
``--export-aot``, ``--solve``, ``--json-out``, ``--x``, ``--profile``,
``--analyze``, ``--no-report``.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

import numpy as np

__all__ = ["main", "build_parser"]

ALG_CSR = "CSR"
ALG_TJDS = "TJDS"
ALG_CISR = "CISR"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="smvp-toolkit-tpu",
        description=(
            "Sparse-matrix codec + SpMV benchmark on JAX "
            "(CSR / TJDS / CISR)"
        ),
    )
    p.add_argument("file", help="input MatrixMarket (.mtx) file")
    p.add_argument(
        "-a",
        "--all-algs",
        action="store_true",
        help="benchmark all algorithms (CSR + TJDS + CISR export)",
    )
    p.add_argument("-c", "--csr", action="store_true", help="benchmark CSR SpMV")
    p.add_argument("-t", "--tjds", action="store_true", help="benchmark TJDS SpMV")
    p.add_argument(
        "-g",
        "--cisr-gen",
        action="store_true",
        help="generate a CISR .coe memory image",
    )
    p.add_argument(
        "-n",
        "--iter",
        type=int,
        default=1000,
        metavar="ITERATIONS",
        help="number of timed SpMV iterations (default 1000)",
    )
    p.add_argument(
        "-s",
        "--slots",
        type=int,
        default=16,
        metavar="SLOTS",
        help="CISR slot/channel count (default 16)",
    )
    p.add_argument(
        "-d",
        "--dir",
        default="",
        metavar="DIR",
        help="report output directory (default: current directory)",
    )
    # --- extensions ------------------------------------------------------
    p.add_argument(
        "--kernel",
        choices=["auto", "xla", "native", "df64"],
        default="auto",
        help=(
            "SpMV kernel implementation (auto: the fastest device route "
            "for the platform; xla = gather + segment-sum; native = C++ "
            "CPU backend; df64 = double-float compensated CSR on f32 "
            "values)"
        ),
    )
    p.add_argument(
        "--dtype",
        choices=["float32", "bfloat16"],
        default="float32",
        help="device value dtype",
    )
    p.add_argument(
        "--expand-symmetry",
        action="store_true",
        help=(
            "expand symmetric/skew/hermitian storage to the full matrix "
            "(the reference multiplies stored entries only)"
        ),
    )
    p.add_argument(
        "--decode-check",
        action="store_true",
        help="verify decode(encode(A)) reproduces the loaded COO bit-exactly",
    )
    p.add_argument(
        "--coe-out",
        default=None,
        metavar="FILE",
        help="write the CISR .coe image to FILE instead of stdout",
    )
    p.add_argument(
        "--shards",
        type=int,
        default=1,
        metavar="N",
        help="data-parallel shards (row blocks) across devices",
    )
    p.add_argument(
        "--shard-balance",
        choices=("rows", "nnz"),
        default="rows",
        help=(
            "row-block boundaries: equal rows (default) or equal-nnz "
            "quantiles (balances skewed matrices; CSR shards only)"
        ),
    )
    p.add_argument(
        "--no-report",
        action="store_true",
        help="skip writing the report file",
    )
    p.add_argument(
        "--debug",
        action="store_true",
        help=(
            "dump encoded-format internals to stderr (reference "
            "SMVP_CSR_DEBUG/SMVP_TJDS_DEBUG printf harness analog)"
        ),
    )
    p.add_argument(
        "--lut-out",
        default=None,
        metavar="FILE",
        help=(
            "write the TJDS Verilog LUT image to FILE (parameterized, "
            "opt-in replacement for the reference's hardcoded LUT spew)"
        ),
    )
    p.add_argument(
        "--save-encoded",
        default=None,
        metavar="PREFIX",
        help="checkpoint encoded matrices to PREFIX_{csr,tjds}.npz",
    )
    p.add_argument(
        "--solve",
        default=None,
        metavar="METHOD[:ITERS[:TOL]]",
        help=(
            "after benchmarking, solve A x = b with an iterative method "
            "(cg, pcg, pcg-amg, pcg-cheb, pcg-neumann, pcg-ic0, "
            "pcg-ssor, pcg-bjac, bicgstab, bicgstab-ilu, bicgstab-amg, "
            "gmres, gmres-ilu, gmres-amg, minres, chebyshev; default "
            "100 iterations; an optional third "
            "field sets a relative-residual target with on-device "
            "early stop (per-iteration for the CG family and minres; "
            "per-restart for gmres), e.g. cg:200:1e-6) using "
            "the --x vector as b; logs the relative residual and "
            "writes the solution into a SOLVE report"
        ),
    )
    p.add_argument(
        "--spmm",
        type=int,
        default=None,
        metavar="K",
        help=(
            "additionally benchmark the multi-vector SpMM Y = A·X with "
            "K right-hand sides on the CSR encoding (gather + "
            "segment-sum SpMM). Requires the CSR algorithm (-c or -a)."
        ),
    )
    p.add_argument(
        "--eigs",
        default=None,
        metavar="K[:ITERS]",
        help=(
            "after benchmarking, compute the K smallest eigenpairs of "
            "the (symmetric) matrix with LOBPCG (default 60 iterations"
            "), AMG-preconditioned when the hierarchy builds; logs the "
            "Ritz values and eigen-residuals. Requires -c or -a."
        ),
    )
    p.add_argument(
        "--json-out",
        default=None,
        metavar="FILE",
        help=(
            "append one JSON line per benchmarked algorithm (machine-"
            "readable metrics sink alongside the text reports)"
        ),
    )
    p.add_argument(
        "--export-aot",
        default=None,
        metavar="PREFIX",
        help=(
            "AOT-export the compiled SpMV program (matrix baked in) to "
            "PREFIX_{csr,tjds}.jaxexport — a serving process deserializes "
            "with jax.export and calls, no framework import needed"
        ),
    )
    p.add_argument(
        "--profile",
        default=None,
        metavar="DIR",
        help="capture a jax.profiler device trace of the SpMV into DIR",
    )
    p.add_argument(
        "--analyze",
        action="store_true",
        help="print matrix structure statistics and kernel plan metrics",
    )
    p.add_argument(
        "--x",
        default="ones",
        metavar="MODE",
        help=(
            "input vector: 'ones' (reference protocol, main-cli.c:368), "
            "'random' or 'random:SEED' (standard normal) — random x "
            "exercises the per-position indexing the reference's x=ones "
            "could never distinguish (SURVEY.md §B4)"
        ),
    )
    p.add_argument(
        "--fused",
        action="store_true",
        help=(
            "time the N iterations as one on-device loop (eliminates "
            "host dispatch overhead between iterations)"
        ),
    )
    return p


def _validate(args) -> Optional[str]:
    """Reference-equivalent validation (main-cli.c:1274-1386)."""
    if args.all_algs and (args.csr or args.tjds or args.cisr_gen):
        return "--all-algs cannot be combined with individual algorithm flags"
    if not (args.all_algs or args.csr or args.tjds or args.cisr_gen):
        return "no algorithm selected (use -a, -c, -t and/or -g)"
    if args.iter < 1:
        return "iteration count must be >= 1"
    if args.slots < 1 or args.slots > 255:
        return "slot count must be in 1..255 (8-bit field in the COE format)"
    if args.dir and not os.path.isdir(args.dir):
        return f"report directory does not exist: {args.dir}"
    if args.shards < 1:
        return "shard count must be >= 1"
    if getattr(args, "fused", False) and args.shards > 1:
        return "--fused is not supported together with --shards"
    run_csr = args.csr or args.all_algs
    run_tjds = args.tjds or args.all_algs
    if args.lut_out and not run_tjds:
        return "--lut-out requires the TJDS algorithm (-t or -a)"
    if args.save_encoded and not (run_csr or run_tjds):
        return "--save-encoded requires -c, -t or -a"
    if args.export_aot and not (run_csr or run_tjds):
        return "--export-aot requires -c, -t or -a"
    if args.spmm is not None:
        if args.spmm < 1:
            return "--spmm K must be >= 1"
        if not run_csr:
            return "--spmm requires the CSR algorithm (-c or -a)"
    if args.eigs is not None:
        parts = args.eigs.split(":")
        if len(parts) > 2:
            return f"--eigs takes K[:ITERS] (got {args.eigs!r})"
        try:
            if int(parts[0]) < 1 or (len(parts) > 1 and int(parts[1]) < 1):
                return f"bad --eigs spec: {args.eigs!r}"
        except ValueError:
            return f"bad --eigs spec: {args.eigs!r}"
        if not run_csr:
            return "--eigs requires the CSR algorithm (-c or -a)"
    if args.solve:
        if not run_csr:
            return "--solve requires the CSR encoding (-c or -a)"
        method = args.solve.split(":", 1)[0].lower()
        if method not in SOLVE_METHODS:
            return (
                f"--solve method must be one of {', '.join(SOLVE_METHODS)} "
                f"(got {method!r})"
            )
        parts = args.solve.split(":")
        if len(parts) > 3:
            return f"--solve takes METHOD[:ITERS[:TOL]] (got {args.solve!r})"
        if len(parts) > 1:
            try:
                if int(parts[1]) < 1:
                    return f"bad --solve iteration count: {args.solve!r}"
            except ValueError:
                return f"bad --solve iteration count: {args.solve!r}"
        if len(parts) > 2:
            try:
                if not 0 < float(parts[2]) < 1:
                    return f"bad --solve tolerance: {args.solve!r}"
            except ValueError:
                return f"bad --solve tolerance: {args.solve!r}"
    if args.decode_check and not (run_csr or run_tjds):
        return "--decode-check requires -c, -t or -a"
    return None


# Options of the removed SELL kernel family. They are refused with exit
# code 2, never remapped to another kernel.
_REMOVED_OPTIONS = {
    "--cocluster": "--cocluster was removed with the SELL kernel it "
                   "planned for",
    "--kernel=pallas": "--kernel pallas was removed; choose auto, xla, "
                       "native or df64",
}


def _removed_option(argv: List[str]) -> Optional[str]:
    for i, arg in enumerate(argv):
        if arg == "--kernel" and argv[i + 1:i + 2] == ["pallas"]:
            arg = "--kernel=pallas"
        if arg in _REMOVED_OPTIONS:
            return _REMOVED_OPTIONS[arg]
    return None


def main(argv: Optional[List[str]] = None) -> int:
    from smvp_toolkit_tpu.utils.logging import log

    argv = sys.argv[1:] if argv is None else list(argv)
    removed = _removed_option(argv)
    if removed:
        log("ERROR", removed)
        return 2
    args = build_parser().parse_args(argv)
    err = _validate(args)
    if err:
        log("ERROR", err)
        return 2

    log("START", "smvp-toolkit-tpu benchmark run starting.")

    from smvp_toolkit_tpu.utils.compile_cache import configure_compile_cache

    configure_compile_cache()

    import jax
    import jax.numpy as jnp

    from smvp_toolkit_tpu import __version__, read_mtx
    from smvp_toolkit_tpu.bench import (
        bench_spmv,
        spmv_bytes_csr,
        spmv_bytes_tjds,
        roofline_fraction,
        write_report,
    )
    from smvp_toolkit_tpu.formats.cisr import cisr_encode, write_coe
    from smvp_toolkit_tpu.formats.csr import csr_encode, csr_decode
    from smvp_toolkit_tpu.formats.tjds import tjds_encode, tjds_decode
    from smvp_toolkit_tpu.io.mtx import MTXError
    from smvp_toolkit_tpu.ops import csr_spmv_for, spmv_csr, spmv_tjds

    dtype = jnp.bfloat16 if args.dtype == "bfloat16" else jnp.float32

    if args.file.startswith("synth:"):
        # synth:N:NNZ — banded synthetic matrix (BASELINE.json scaling
        # configs through the official surface; same syntax as smvp-dist).
        from smvp_toolkit_tpu.utils.synth import parse_synth_spec

        log("FILE", f"Generating synthetic banded matrix {args.file}")
        try:
            coo = parse_synth_spec(args.file)
        except ValueError as e:
            log("ERROR", str(e))
            return 2
    else:
        log("FILE", f"Loading matrix: {args.file}")
        from smvp_toolkit_tpu.io.mtx import MTXUnsupportedType

        try:
            try:
                coo = read_mtx(
                    args.file, expand_symmetry=args.expand_symmetry,
                    dtype=dtype,
                )
            except MTXUnsupportedType as e:
                if "complex" not in str(e):
                    raise
                # Complex matrix with a real --dtype: promote rather than
                # refuse (the refusal protects library users from silent
                # imaginary-part loss; the CLI just picks the right dtype).
                log("INFO", "complex matrix: using complex64 values.")
                coo = read_mtx(
                    args.file, expand_symmetry=args.expand_symmetry,
                    dtype=None,
                )
        except FileNotFoundError:
            log("ERROR", f"could not open file: {args.file}")
            return 1
        except MTXError as e:
            log("ERROR", f"MatrixMarket read failed: {e}")
            return 1

    coo = coo.pad(128)
    log(
        "DATA",
        f"{coo.shape[0]}x{coo.shape[1]} matrix, {coo.nnz} non-zeros "
        f"({coo.typecode}).",
    )

    device = jax.devices()[0]
    log("INFO", f"Device: {device.device_kind} ({device.platform})")

    run_csr = args.csr or args.all_algs
    run_tjds = args.tjds or args.all_algs
    run_cisr = args.cisr_gen or args.all_algs

    # x = ones by default, like the reference (main-cli.c:761-762, 368).
    x_dtype = (
        jnp.complex64
        if jnp.issubdtype(coo.dtype, jnp.complexfloating) else dtype
    )
    if args.x == "ones":
        x = jnp.ones((coo.shape[1],), dtype=x_dtype)
    elif args.x == "random" or args.x.startswith("random:"):
        try:
            seed = int(args.x.split(":", 1)[1]) if ":" in args.x else 0
        except ValueError:
            log("ERROR", f"bad --x seed (want random:INT): {args.x!r}")
            return 2
        rng = np.random.default_rng(seed)
        x = jnp.asarray(
            rng.standard_normal(coo.shape[1]), dtype=x_dtype
        )
    else:
        log("ERROR", f"unknown --x mode: {args.x!r}")
        return 2
    exit_code = 0

    def _spmv_fns():
        if jnp.issubdtype(coo.dtype, jnp.complexfloating):
            # The native/df64 kernels are real-valued; complex SpMV
            # runs on the XLA kernels (which support complex64 end to
            # end) rather than silently dropping imaginary parts.
            if args.kernel not in ("auto", "xla"):
                log("INFO", "complex matrix: --kernel "
                    f"{args.kernel} unsupported, using XLA kernels.")
            return spmv_csr, spmv_tjds, "xla"
        if args.kernel == "df64":
            # Double-float compensated CSR (ops/precision.py): f32 values
            # with an error-free product and compensated row sums.
            from smvp_toolkit_tpu.ops.precision import spmv_csr_df64

            def csr_df64(encoded, xx):
                xx = xx.astype(jnp.float32)
                hi, lo = spmv_csr_df64(encoded, xx, jnp.zeros_like(xx))
                return hi + lo  # f32 carries the displayed result

            def tjds_df64(encoded, xx):
                # No TJDS double-float variant; compensated CSR semantics
                # require row-major prefix structure. TJDS falls back.
                return spmv_tjds(encoded, xx)

            # The fallback must not be misreported as extended precision.
            tjds_df64.kernel_label = "xla"
            log("INFO", "df64 is CSR-only; TJDS runs the plain XLA kernel.")
            return csr_df64, tjds_df64, "df64"
        if args.kernel == "native":
            from smvp_toolkit_tpu.ops.spmv_native import (
                NativeCsrSpMV,
                native_spmv_available,
            )

            if not native_spmv_available():
                log("ERROR", "native backend not built "
                    "(make -C smvp_toolkit_tpu/native)")
                raise SystemExit(1)

            from smvp_toolkit_tpu.ops.spmv_native import NativeTjdsSpMV

            # Operator cache: building the ctypes operator re-copies the
            # format arrays; benchmark loops must reuse one instance.
            ops = {}

            def _native_op(alg, encoded):
                op = ops.get((alg, id(encoded)))
                if op is None:
                    cls = NativeCsrSpMV if alg == ALG_CSR else NativeTjdsSpMV
                    op = cls(encoded)
                    ops[(alg, id(encoded))] = op
                return op

            def csr_native(encoded, xx):
                return jnp.asarray(_native_op(ALG_CSR, encoded)(np.asarray(xx)))

            def tjds_native(encoded, xx):
                return jnp.asarray(
                    _native_op(ALG_TJDS, encoded)(np.asarray(xx))
                )

            csr_native.native_op = lambda e: _native_op(ALG_CSR, e)
            tjds_native.native_op = lambda e: _native_op(ALG_TJDS, e)
            return csr_native, tjds_native, "native"
        label, csr_auto = csr_spmv_for(device.platform, coo.dtype)
        if args.kernel == "auto" and label == "cusparse":
            # TJDS has no library route and stays on the XLA kernel.
            def tjds_xla(encoded, xx):
                return spmv_tjds(encoded, xx)

            tjds_xla.kernel_label = "xla"
            return csr_auto, tjds_xla, label
        return spmv_csr, spmv_tjds, "xla"

    csr_fn, tjds_fn, kernel_kind = _spmv_fns()

    def _run(alg_name, encoded, spmv_fn, bytes_per_iter, force_kernel=None):
        # The kernel actually benchmarked (a wrapper may override its
        # label when it falls back, e.g. df64's TJDS path).
        run_kernel = getattr(spmv_fn, "kernel_label", kernel_kind)
        use_shards = args.shards > 1 and force_kernel is None
        if force_kernel is not None:
            if kernel_kind != force_kernel or args.shards > 1:
                log("INFO", f"{alg_name} SpMV runs on the {force_kernel} "
                    "kernel (no sharded/native variant).")
            run_kernel = force_kernel
        elif args.shards > 1 and run_kernel != "xla":
            # The sharded path runs the XLA kernels under shard_map.
            # Report what actually ran.
            log("INFO", f"--shards runs the XLA kernels, not {run_kernel}.")
            run_kernel = "xla"
        log("INFO", f"Benchmarking {alg_name} SpMV ({run_kernel} kernel), "
            f"{args.iter} iterations.")
        if use_shards:
            from smvp_toolkit_tpu.parallel import shard_and_bench

            stats, y = shard_and_bench(
                alg_name, encoded, x, args.shards, iterations=args.iter,
                balance=args.shard_balance,
            )
        elif kernel_kind == "native" and force_kernel is None:
            # Batch iterations inside the C loop (both --fused and
            # per-call modes): a traced fori_loop cannot call ctypes, and
            # batching amortizes the ~2.7 us dispatch floor that would
            # otherwise dominate sub-300-nnz matrices.
            from smvp_toolkit_tpu.bench import bench_native_batched

            stats = bench_native_batched(
                spmv_fn.native_op(encoded), x, iterations=args.iter
            )
            y = None
        elif args.fused:
            from smvp_toolkit_tpu.bench import bench_spmv_fused

            stats = bench_spmv_fused(
                spmv_fn, encoded, x, iterations=args.iter, repeats=3
            )
            y = None
        else:
            stats = bench_spmv(spmv_fn, encoded, x, iterations=args.iter)
            y = None
        if y is None:
            y = np.asarray(spmv_fn(encoded, x))
        if args.profile:
            from smvp_toolkit_tpu.bench.profile import profile_fn

            profile_fn(spmv_fn, encoded, x,
                       log_dir=os.path.join(args.profile, alg_name))
            log("FILE", f"Profiler trace: {args.profile}/{alg_name}")
        nnzs = stats.nnz_per_s(coo.nnz)
        gbs = stats.gb_per_s(bytes_per_iter)
        frac = roofline_fraction(gbs, device)
        log(
            "DATA",
            f"{alg_name}: avg {stats.avg_ms:.6f} ms  "
            f"({nnzs/1e9:.3f} Gnnz/s, {gbs:.1f} GB/s eff, "
            f"{100*frac:.1f}% of roofline)",
        )
        if args.json_out:
            rec = {
                "alg": alg_name,
                "file": args.file,
                "nnz": coo.nnz,
                "iterations": args.iter,
                "kernel": run_kernel,
                "device": f"{device.device_kind} ({device.platform})",
                "avg_ms": stats.avg_ms,
                "min_ms": float(stats.min_ms),
                "max_ms": float(stats.max_ms),
                "stdev_ms": float(stats.stdev_ms),
                "per_launch_stats": bool(getattr(stats, "per_launch",
                                                 False)),
                "nnz_per_s": nnzs,
                "eff_gb_s": gbs,
                "roofline_frac": frac,
            }
            _append_json(args.json_out, rec)
            log("FILE", f"JSON record appended: {args.json_out}")
        if not args.no_report:
            path = write_report(
                args.dir,
                alg_name=alg_name,
                input_file=args.file,
                nnz=coo.nnz,
                iterations=args.iter,
                stats=stats,
                output_vector=y[: coo.shape[0]],
                extra_metrics={
                    "Device": f"{device.device_kind} ({device.platform})",
                    "Kernel": run_kernel,
                    "nnz/s": f"{nnzs:.4g}",
                    "Effective GB/s": f"{gbs:.4g}",
                    "Roofline fraction": f"{frac:.4g}",
                },
            )
            log("FILE", f"Execution report file saved as:\n\t{path}")

    vbytes = jnp.dtype(dtype).itemsize

    if args.analyze:
        from smvp_toolkit_tpu.utils.analyze import analyze, format_analysis

        log("DATA", "Matrix analysis:")
        for line in format_analysis(analyze(coo)).splitlines():
            print(f"\t{line}")

    from smvp_toolkit_tpu.utils.debug import debug_enabled

    debug_on = args.debug or debug_enabled()
    if debug_on:
        from smvp_toolkit_tpu.utils.debug import dump_coo

        dump_coo(coo)

    if run_csr:
        csr = csr_encode(coo)
        if debug_on:
            from smvp_toolkit_tpu.utils.debug import dump_csr

            dump_csr(csr)
        if args.decode_check:
            _decode_check("CSR", csr_decode(csr), coo, log)
        if args.save_encoded:
            from smvp_toolkit_tpu.utils.checkpoint import save_matrix

            save_matrix(f"{args.save_encoded}_csr.npz", csr)
            log("FILE", f"CSR checkpoint: {args.save_encoded}_csr.npz")
        if args.export_aot:
            _export_aot(args.export_aot, "CSR", csr, log)
        _run(ALG_CSR, csr, csr_fn, spmv_bytes_csr(coo.nnz, coo.shape[0], vbytes))
        if args.spmm:
            _run_spmm(args, coo, csr, kernel_kind, device, log)
        if args.eigs:
            rc = _run_eigs(args, coo, csr, device, log)
            if rc:
                return rc
        if args.solve:
            # native/df64 cannot run inside the jitted solver loops: the
            # default XLA kernel serves them.
            solve_spmv = csr_fn if kernel_kind in ("xla", "cusparse") else None
            rc = _run_solve(args, coo, csr, x, device, log,
                            spmv=solve_spmv)
            if rc:
                return rc

    if run_tjds:
        tj = tjds_encode(coo)
        if debug_on:
            from smvp_toolkit_tpu.utils.debug import dump_tjds

            dump_tjds(tj)
        if args.decode_check:
            _decode_check("TJDS", tjds_decode(tj), coo, log)
        if args.save_encoded:
            from smvp_toolkit_tpu.utils.checkpoint import save_matrix

            save_matrix(f"{args.save_encoded}_tjds.npz", tj)
            log("FILE", f"TJDS checkpoint: {args.save_encoded}_tjds.npz")
        if args.export_aot:
            _export_aot(args.export_aot, "TJDS", tj, log)
        if args.lut_out:
            from smvp_toolkit_tpu.formats.vivado import write_tjds_lut

            write_tjds_lut(tj, args.lut_out)
            log("FILE", f"TJDS Verilog LUT image saved as:\n\t{args.lut_out}")
        _run(
            ALG_TJDS,
            tj,
            tjds_fn,
            spmv_bytes_tjds(coo.nnz, coo.shape[0], int(tj.num_diags), vbytes),
        )

    if run_cisr:
        log("INFO", f"Generating CISR schedule with {args.slots} slots.")
        cisr = cisr_encode(coo, slot_count=args.slots)
        try:
            text = write_coe(cisr, args.coe_out)
        except ValueError as e:
            log("ERROR", f"COE export failed: {e}")
            return 1
        if args.coe_out:
            log("FILE", f"CISR COE image saved as:\n\t{args.coe_out}")
        else:
            print(text)
        # Compute with the schedule — the capability the reference only
        # gestures at (its CISR path stops at .coe emission,
        # main-cli.c:542-612): channel-per-lane interleaved SpMV (XLA).
        from smvp_toolkit_tpu.bench import spmv_bytes_cisr
        from smvp_toolkit_tpu.ops import spmv_cisr as cisr_fn

        _run(
            ALG_CISR,
            cisr,
            cisr_fn,
            spmv_bytes_cisr(
                cisr.num_groups, cisr.slot_count, coo.shape[0], vbytes
            ),
            force_kernel="xla",
        )

    log("STOP", "smvp-toolkit-tpu run complete.")
    return exit_code


SOLVE_METHODS = ("cg", "pcg", "pcg-amg", "pcg-cheb", "pcg-neumann",
                 "pcg-ic0", "pcg-ssor", "pcg-bjac", "bicgstab",
                 "bicgstab-ilu", "bicgstab-amg", "gmres", "gmres-ilu",
                 "gmres-amg", "minres", "chebyshev")


def _append_json(path, record) -> None:
    """Append one JSON line to the machine-readable metrics sink."""
    import json

    with open(path, "a") as f:
        f.write(json.dumps(record) + "\n")


def _export_aot(prefix, fmt, matrix, log) -> None:
    from smvp_toolkit_tpu.utils.aot import export_spmv, write_blob

    path = f"{prefix}_{fmt.lower()}.jaxexport"
    write_blob(path, export_spmv(matrix))
    log("FILE", f"{fmt} AOT program: {path}")


def _run_solve(args, coo, csr, x, device, log, spmv=None):
    """``--solve METHOD[:ITERS[:TOL]]``: solve A x = b, b = --x vector.

    Runs on the benchmarked CSR encoding with the selected jittable
    kernel (the native ctypes kernel cannot run inside the solvers'
    scanned loops). Logs wall time and relative residual;
    writes a SOLVE report with the solution vector.
    """
    import time as _time

    import jax.numpy as jnp

    from smvp_toolkit_tpu.models import (
        bicgstab,
        chebyshev,
        conjugate_gradient,
        gmres,
        lanczos_eigsh,
        minres,
        pcg,
    )
    from smvp_toolkit_tpu.ops import spmv_csr
    from smvp_toolkit_tpu.ops.algebra import diagonal

    if coo.shape[0] != coo.shape[1]:
        log("ERROR", "--solve needs a square system")
        return 2
    if spmv is None:
        spmv = spmv_csr
    spec = args.solve.split(":")
    method = spec[0].lower()
    iters = int(spec[1]) if len(spec) > 1 else 100
    # Optional third field: relative-residual target — on-device early
    # stop for every iterative method except chebyshev (a fixed
    # polynomial); minres/cg stop per step, gmres per restart cycle.
    tol = float(spec[2]) if len(spec) > 2 else None
    per = 1  # reported iterations per residual-history entry
    # Solve in the matrix's compute dtype: a complex system must carry
    # a complex b (the solver scan carries would otherwise mismatch).
    is_complex = jnp.issubdtype(csr.vals.dtype, jnp.complexfloating)
    if is_complex and method == "chebyshev":
        log("ERROR", f"--solve {method} needs a real SPD system")
        return 2
    b_dtype = csr.vals.dtype if is_complex else jnp.float32
    b = x[: coo.shape[0]].astype(b_dtype)

    def _lanczos_bounds(safety_lo=0.3, safety_hi=1.1):
        """Spectrum bounds for Chebyshev intervals, with safety margins.

        A RANDOM start vector (ones is an exact eigenvector of
        constant-row-sum matrices, which collapses the Ritz set), and a
        deliberately aggressive lower cushion: single-pass Lanczos
        routinely OVERestimates lambda_min, and an interval that misses
        the true bottom of the spectrum makes the Chebyshev polynomial
        indefinite (silent CG stall / divergence). Underestimating only
        costs acceleration.
        """
        import numpy as _np

        v0 = jnp.asarray(
            _np.random.default_rng(0).standard_normal(b.shape[0]),
            b.dtype,
        )
        lows, highs = lanczos_eigsh(
            csr, v0, num_iters=min(30, coo.shape[0]), k=1, spmv=spmv,
        )
        return float(lows[0]) * safety_lo, float(highs[0]) * safety_hi

    t0 = _time.perf_counter()
    if method == "cg":
        xs, res = conjugate_gradient(csr, b, num_iters=iters, spmv=spmv,
                                     tol=tol)
    elif method == "pcg":
        xs, res = pcg(csr, b, diagonal(coo), num_iters=iters, spmv=spmv,
                      tol=tol)
    elif method in ("pcg-cheb", "pcg-neumann"):
        # Polynomial preconditioners: the apply is pure SpMV + AXPY
        # (zero inner products) — communication-avoiding under sharding.
        from smvp_toolkit_tpu.models import (
            chebyshev_preconditioner,
            jacobi_preconditioner,
            pcg_precond,
        )

        if is_complex:
            log("ERROR", f"--solve {method} needs a real SPD system")
            return 2
        if method == "pcg-cheb":
            lo, hi = _lanczos_bounds()
            m = chebyshev_preconditioner(csr, lo, hi, degree=8, spmv=spmv)
        else:
            m = jacobi_preconditioner(
                csr, diagonal(coo), order=3, spmv=spmv
            )
        xs, res = pcg_precond(csr, b, m, num_iters=iters, spmv=spmv,
                              tol=tol)
    elif method == "pcg-ic0":
        # Incomplete-Cholesky PCG: host-side IC(0) factorization at
        # solve setup, fixed-sweep Neumann
        # triangular applies on device — exactly symmetric PD at any
        # sweep count (ops/ilu.py), so CG-safe even inexact.
        from smvp_toolkit_tpu.models import ic0_preconditioner, pcg_precond
        from smvp_toolkit_tpu.ops.ilu import ic0

        if is_complex:
            log("ERROR", f"--solve {method} needs a real SPD system")
            return 2
        try:
            factors = ic0(csr)
        except ValueError as e:  # shift ladder exhausted — nowhere near SPD
            log("ERROR", str(e))
            return 2
        m = ic0_preconditioner(factors, sweeps=4)
        xs, res = pcg_precond(csr, b, m, num_iters=iters, spmv=spmv,
                              tol=tol)
    elif method == "pcg-amg":
        # Smoothed-aggregation multigrid: host-side hierarchy setup
        # (strength graph → aggregation → smoothed P → Galerkin coarse
        # operators), fixed-shape V-cycle applies on device — iteration
        # counts independent of problem size on elliptic systems.
        from smvp_toolkit_tpu.models import amg_preconditioner, pcg_precond

        if is_complex:
            log("ERROR", f"--solve {method} needs a real SPD system")
            return 2
        try:
            m = amg_preconditioner(csr, sweeps=1)
        except ValueError as e:  # aggregation stalled past the dense cap
            log("ERROR", str(e))
            return 2
        xs, res = pcg_precond(csr, b, m, num_iters=iters, spmv=spmv,
                              tol=tol)
    elif method == "pcg-ssor":
        # SSOR: zero-setup preconditioner (triangular split of A, no
        # factorization); same fixed-sweep trisolve machinery, exactly
        # symmetric for symmetric A at equal sweep counts.
        from smvp_toolkit_tpu.models import pcg_precond, ssor_preconditioner

        if is_complex:
            log("ERROR", f"--solve {method} needs a real SPD system")
            return 2
        m = ssor_preconditioner(csr, omega=1.0, sweeps=4)
        xs, res = pcg_precond(csr, b, m, num_iters=iters, spmv=spmv,
                              tol=tol)
    elif method == "pcg-bjac":
        # Block-Jacobi: dense diagonal blocks inverted ONCE as a batched
        # (nb, b, b) program; each apply is a single batched mat-vec.
        from smvp_toolkit_tpu.models import (
            block_jacobi_preconditioner,
            pcg_precond,
        )

        if is_complex:
            log("ERROR", f"--solve {method} needs a real SPD system")
            return 2
        try:
            m = block_jacobi_preconditioner(csr, block=64)
        except ValueError as e:  # ridge ladder exhausted
            log("ERROR", str(e))
            return 2
        xs, res = pcg_precond(csr, b, m, num_iters=iters, spmv=spmv,
                              tol=tol)
    elif method in ("bicgstab-ilu", "bicgstab-amg",
                    "gmres-ilu", "gmres-amg"):
        # Right-preconditioned Krylov via the injectable kernel: solve
        # (A·M⁻¹) u = b with the wrapped spmv, then x = M⁻¹ u. The
        # residual b − A·M⁻¹·u the solver tracks IS the true residual
        # of x, so tol early-stop semantics are unchanged. The -ilu
        # variants factor A itself (general systems); the -amg variants
        # build the hierarchy on the symmetric part (A+Aᵀ)/2 — the
        # standard recipe for mildly nonsymmetric systems, measured
        # 2.6x fewer iterations than ILU on convection-diffusion.
        if is_complex:
            log("ERROR", f"--solve {method} supports real systems only")
            return 2
        try:
            if method.endswith("-ilu"):
                from smvp_toolkit_tpu.models import ilu_preconditioner
                from smvp_toolkit_tpu.ops.ilu import ilu0

                m_apply = ilu_preconditioner(ilu0(csr), sweeps=4)
            else:
                from smvp_toolkit_tpu.formats.csr import csr_encode as _enc
                from smvp_toolkit_tpu.models import amg_preconditioner
                from smvp_toolkit_tpu.ops.algebra import (
                    _as_general,
                    add,
                    scale,
                    transpose,
                )

                # Expand one-triangle storage first: transpose() of a
                # symmetric-typecode COO transposes only the stored
                # triangle, which would make "(A+Aᵀ)/2" nonsymmetric.
                g = _as_general(coo)
                sym = scale(add(g, transpose(g)), 0.5)
                m_apply = amg_preconditioner(_enc(sym))
        except ValueError as e:  # shift ladder / aggregation exhausted
            log("ERROR", str(e))
            return 2
        wrapped = lambda mat, v: spmv(mat, m_apply(v))  # noqa: E731
        if method.startswith("gmres"):
            restart = min(20, iters)
            num_restarts = max(1, -(-iters // restart))
            iters = restart * num_restarts
            per = restart
            us, res = gmres(
                csr, b, restart=restart, num_restarts=num_restarts,
                spmv=wrapped, tol=tol,
            )
        else:
            us, res = bicgstab(csr, b, num_iters=iters, tol=tol,
                               spmv=wrapped)
        xs = m_apply(us)
    elif method == "bicgstab":
        xs, res = bicgstab(csr, b, num_iters=iters, spmv=spmv,
                           tol=tol)
    elif method == "minres":
        xs, res = minres(csr, b, num_iters=iters, spmv=spmv, tol=tol)
    elif method == "gmres":
        restart = min(20, iters)
        num_restarts = max(1, -(-iters // restart))
        iters = restart * num_restarts
        per = restart  # one residual-history entry per restart cycle
        xs, res = gmres(
            csr, b, restart=restart, num_restarts=num_restarts, spmv=spmv,
            tol=tol,
        )
    else:  # chebyshev — SPD systems; spectrum bounds from Lanczos
        lo, hi = _lanczos_bounds()
        xs, res = chebyshev(csr, b, lo, hi, num_iters=iters, spmv=spmv)
    xs.block_until_ready()
    ms = (_time.perf_counter() - t0) * 1e3
    if tol is not None and method != "chebyshev":
        # Recover the ACHIEVED iteration count from the residual
        # history: entries past the stopping step repeat the final norm
        # (_while_solve contract), so the first entry at/below the
        # target is the stopping step. Without this the log/json would
        # report the requested count even when tol stopped early.
        rn = np.asarray(res, np.float64)
        # Mirror the DEVICE's stopping target (tol * f32-norm of b, see
        # _while_solve) with a hair of slack: recomputing it in f64
        # could land above the device target by one ulp and report the
        # requested count for a run that demonstrably stopped early.
        tgt = tol * max(float(np.linalg.norm(np.asarray(b))), 1e-30)
        hit = np.nonzero(rn <= tgt * (1.0 + 1e-6))[0]
        iters = (int(hit[0]) + 1 if hit.size else rn.shape[0]) * per

    res_dtype = np.complex128 if is_complex else np.float64
    r = np.asarray(b, res_dtype) - np.asarray(
        spmv_csr(csr, xs), res_dtype
    )
    relres = float(
        np.linalg.norm(r) / max(np.linalg.norm(np.asarray(b)), 1e-30)
    )
    log(
        "DATA",
        f"SOLVE {method}: {iters} iterations in {ms:.2f} ms, "
        f"relative residual {relres:.3e}",
    )
    if not np.isfinite(relres) or relres > 1.0:
        spd_methods = ("cg", "pcg", "pcg-amg", "pcg-cheb",
                       "pcg-neumann", "pcg-ic0", "pcg-ssor", "pcg-bjac",
                       "chebyshev")
        hint = (
            "more iterations, a tighter preconditioner (larger ILU "
            "sweeps), or gmres"
            if method in ("bicgstab-ilu", "bicgstab-amg",
                          "gmres-ilu", "gmres-amg")
            else "bicgstab or gmres for general matrices"
        )
        log(
            "INFO",
            f"solve did not converge — {method} assumes "
            + ("an SPD system" if method in spd_methods
               else "a symmetric system" if method == "minres"
               else "a well-conditioned system")
            + f"; try {hint}",
        )
    if args.json_out:
        _append_json(args.json_out, {
            "alg": f"SOLVE-{method.upper()}",
            "file": args.file,
            "iterations": iters,
            "wall_ms": ms,
            "relative_residual": relres,
            "device": f"{device.device_kind} ({device.platform})",
        })
    if not args.no_report:
        from smvp_toolkit_tpu.bench.harness import TimingStats
        from smvp_toolkit_tpu.bench.report import write_report

        path = write_report(
            args.dir,
            alg_name=f"SOLVE-{method.upper()}",
            input_file=args.file,
            nnz=coo.nnz,
            iterations=iters,
            stats=TimingStats(
                times_ms=np.asarray([ms]), iterations=1, per_launch=True
            ),
            output_vector=np.asarray(xs),
            extra_metrics={
                "Device": f"{device.device_kind} ({device.platform})",
                "Relative residual": f"{relres:.6g}",
            },
        )
        log("FILE", f"Solve report saved as:\n\t{path}")
    return 0


def _run_spmm(args, coo, csr, kernel_kind, device, log) -> None:
    """``--spmm K``: benchmark Y = A·X with K right-hand sides.

    Runs the XLA gather + segment-sum SpMM whatever ``--kernel`` says.
    Aggregate rate is K·nnz per launch.
    """
    import jax.numpy as jnp

    from smvp_toolkit_tpu.bench import bench_spmv, bench_spmv_fused
    from smvp_toolkit_tpu.ops.spmv_xla import spmm_csr

    k = args.spmm
    rng = np.random.default_rng(0)
    X = jnp.asarray(
        rng.standard_normal((coo.shape[1], k)).astype(np.float32)
    )
    if kernel_kind != "xla":
        log("INFO", "--spmm runs on the XLA kernel "
            f"(no {kernel_kind} SpMM variant).")
    log("INFO", "Benchmarking CSR SpMM (xla kernel), "
        f"K={k} right-hand sides, {args.iter} iterations.")
    if args.fused:
        stats = bench_spmv_fused(
            spmm_csr, csr, X, iterations=args.iter, repeats=3
        )
    else:
        stats = bench_spmv(spmm_csr, csr, X, iterations=args.iter)
    nnzs = stats.nnz_per_s(k * coo.nnz)  # K RHS served per launch
    log(
        "DATA",
        f"SPMM k={k}: avg {stats.avg_ms:.6f} ms  "
        f"({nnzs/1e9:.3f} Gnnz/s across {k} RHS)",
    )
    if args.json_out:
        _append_json(args.json_out, {
            "alg": "SPMM-CSR",
            "file": args.file,
            "nnz": coo.nnz,
            "k": k,
            "iterations": args.iter,
            "kernel": "xla",
            "device": f"{device.device_kind} ({device.platform})",
            "avg_ms": stats.avg_ms,
            "nnz_per_s_krhs": nnzs,
        })
        log("FILE", f"JSON record appended: {args.json_out}")


def _run_eigs(args, coo, csr, device, log) -> int:
    """``--eigs K[:ITERS]``: K smallest eigenpairs via LOBPCG.

    AMG-preconditioned when the hierarchy builds (SPD-shaped systems);
    falls back to unpreconditioned LOBPCG otherwise.
    """
    import time as _time

    import jax.numpy as jnp

    from smvp_toolkit_tpu.models import amg_preconditioner, lobpcg

    if coo.shape[0] != coo.shape[1]:
        log("ERROR", "--eigs needs a square (symmetric) matrix")
        return 2
    if jnp.issubdtype(csr.vals.dtype, jnp.complexfloating):
        log("ERROR", "--eigs supports real symmetric systems only")
        return 2
    spec = args.eigs.split(":")
    k = int(spec[0])
    iters = int(spec[1]) if len(spec) > 1 else 60
    n = coo.shape[0]
    if k > n:
        log("ERROR", f"--eigs K={k} exceeds the matrix dimension {n}")
        return 2

    m = None
    try:
        m = amg_preconditioner(csr)
        log("INFO", "LOBPCG preconditioner: smoothed-aggregation AMG")
    except Exception as e:
        log("INFO", f"AMG setup declined ({str(e)[:120]}); "
            "running unpreconditioned LOBPCG")
    rng = np.random.default_rng(0)
    X0 = jnp.asarray(rng.standard_normal((n, k)).astype(np.float32))
    t0 = _time.perf_counter()
    theta, X, res = lobpcg(csr, X0, num_iters=iters, m=m)
    theta.block_until_ready()
    ms = (_time.perf_counter() - t0) * 1e3
    tvals = np.asarray(theta, np.float64)
    rlast = np.asarray(res)[-1]
    log(
        "DATA",
        f"EIGS k={k}: {iters} LOBPCG iterations in {ms:.2f} ms; "
        "smallest Ritz values "
        + " ".join(f"{t:.6g}" for t in tvals)
        + "  (residual norms "
        + " ".join(f"{r:.2e}" for r in rlast) + ")",
    )
    if args.json_out:
        _append_json(args.json_out, {
            "alg": "EIGS-LOBPCG",
            "file": args.file,
            "k": k,
            "iterations": iters,
            "wall_ms": ms,
            "eigenvalues": [float(t) for t in tvals],
            "residual_norms": [float(r) for r in rlast],
            "preconditioner": "amg" if m is not None else "none",
            "device": f"{device.device_kind} ({device.platform})",
        })
        log("FILE", f"JSON record appended: {args.json_out}")
    return 0


def _decode_check(alg, decoded, coo, log):
    canon = coo.canonical_order()
    r, c, v = decoded.canonical_order().to_numpy()
    R, C, V = canon.to_numpy()
    ok = (
        np.array_equal(r, R)
        and np.array_equal(c, C)
        and np.array_equal(
            np.asarray(v).view(np.uint8), np.asarray(V).view(np.uint8)
        )
    )
    if ok:
        log("INFO", f"{alg} decode round-trip: bit-exact ✓")
    else:
        log("ERROR", f"{alg} decode round-trip FAILED")
        raise SystemExit(3)


if __name__ == "__main__":
    sys.exit(main())
