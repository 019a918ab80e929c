#!/usr/bin/env python
"""Smoke test of the toolkit's main path on the GPU.

    python chip_smoke.py                # phases 0-3, one card
    python chip_smoke.py --four-cards   # phase 4 alone, four cards

Phases, each printing one line with its sizes, seconds and measured
error against its tolerance:

0. device — JAX's devices and ``device_kind``, and a 1 GiB
   device-to-device copy rate beside the data-sheet peak.
1. cli-spmv — ``smvp_toolkit_tpu.cli.main`` on ``bench.SPEC``
   (``synth:2000000:24000000``; CSR + TJDS, timed SpMV, decode round
   trip, ``--x random:0``); the reported y checked against scipy in
   float64 with the same x.
2. solve — 200 CG iterations on the 7-point Poisson operator on 128³,
   through both GPU SpMV routes; residual checked against scipy's CG.
3. spmm-grad — k=8 SpMM on the phase-1 matrix, and ``jax.grad`` with
   respect to the values and x, checked against scipy.
4. four-cards — ``synth:8000000:96000000`` over four cards in one
   process: the sharded CLI (CSR by nnz, TJDS, ``--x random:0``), a 2×2
   mesh and sharded SpMM, each checked against the one-card result.

Before the phases it prints ``nvidia-smi``'s card name and power limit.
It exits non-zero, with no result line, when JAX finds no GPU or any
phase fails. The last line of stdout is the result:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
import sys
import tempfile
import time

import numpy as np

from bench import SPEC as PHASE1_SPEC

# Tolerances, with their reasons.
# f32 SpMV rows are sums of about 12 products, taken in another order
# than scipy's; the CLI's report prints y with C's %g (6 significant
# digits, up to 5e-6 relative per cell). No matrix product is involved,
# so TF32 cannot enter. Bound on max|dy| / max|y|:
SPMV_TOL = 1e-5
# f32 CG follows f64 CG until its residual nears f32's floor (about 1e-6
# of |b|); above it, 200 steps of f32 rounding move the Krylov recurrence
# by a few per cent (3.7 % on 96³). Bound on |r32 - r64|, with r the
# relative residual |b - Ax| / |b| of each solve:
CG_REL_TOL = 0.1
CG_ABS_TOL = 1e-5

PHASE4_SPEC = "synth:8000000:96000000"
POISSON_EDGE = 128
CG_ITERS = 200
SPMM_K = 8
# The CLI runs get ``--x random:CLI_X_SEED``; a random x checks the
# column gather and TJDS's permutation, which x = ones would not.
CLI_X_SEED = 0


class PhaseError(AssertionError):
    """A phase's result missed its tolerance or its run failed."""


def rel_max_err(got, ref) -> float:
    """max|got - ref| / max|ref|, in float64 (NaN if either is not finite)."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    if got.shape != ref.shape:
        raise PhaseError(f"shape {got.shape} != reference {ref.shape}")
    if not (np.isfinite(got).all() and np.isfinite(ref).all()):
        return float("nan")
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300))


def check(what: str, err: float, tol: float) -> str:
    """``"what err <= tol"``; raises :class:`PhaseError` when not."""
    text = f"{what} {err:.3e} <= {tol:.0e}"
    if not err <= tol:  # NaN fails too
        raise PhaseError(f"{what} {err:.3e} exceeds {tol:.0e}")
    return text


def check_cg(r32: float, r64: float) -> str:
    """Relative residuals of the f32 and f64 solves agree (see CG_*_TOL)."""
    gap = abs(r32 - r64)
    bound = CG_REL_TOL * r64 + CG_ABS_TOL
    text = f"relres {r32:.4e} vs scipy {r64:.4e}, gap {gap:.2e} <= {bound:.2e}"
    if not gap <= bound:
        raise PhaseError(text.replace("<=", "exceeds"))
    return text


def phases_for(args) -> list:
    """The phases a command line runs: 4 alone with --four-cards."""
    if args.four_cards:
        return ["four-cards"]
    return ["device", "cli-spmv", "solve", "spmm-grad"]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        description="Smoke test of the toolkit's main path on the GPU."
    )
    ap.add_argument(
        "--four-cards", action="store_true",
        help="run only phase 4, the sharded paths over four cards",
    )
    return ap.parse_args(argv)


def _scipy_csr(coo):
    import scipy.sparse as sp

    r, c, v = coo.to_numpy()
    return sp.csr_matrix((v.astype(np.float64), (r, c)), shape=coo.shape)


def _report_vector(report_dir: str, alg: str) -> np.ndarray:
    """The output vector of the CLI report for ``alg`` in ``report_dir``."""
    paths = glob.glob(os.path.join(report_dir, f"smvp-toolbox_report_{alg}_*"))
    if len(paths) != 1:
        raise PhaseError(f"expected one {alg} report, found {paths}")
    with open(paths[0]) as f:
        lines = f.read().splitlines()
    start = lines.index("Output vector (one cell per line):") + 2
    return np.asarray(lines[start:lines.index("]", start)], np.float64)


def cli_x(n: int) -> np.ndarray:
    """The x of the CLI's ``--x random:CLI_X_SEED`` at length ``n``."""
    return np.random.default_rng(CLI_X_SEED).standard_normal(n).astype(
        np.float32)


def _run_cli(argv) -> None:
    from smvp_toolkit_tpu import cli

    rc = cli.main(argv)
    if rc != 0:
        raise PhaseError(f"cli exited {rc}: {' '.join(argv)}")


def phase_device(ctx) -> str:
    import jax

    from smvp_toolkit_tpu.bench.device import copy_gbs
    from smvp_toolkit_tpu.bench.roofline import hbm_bandwidth_gbs

    device = jax.devices()[0]
    print(f"devices: {jax.devices()}")
    print(f"device_kind: {device.device_kind}", flush=True)
    gbs = copy_gbs(ctx.get("copy_bytes", 1 << 30))
    peak = hbm_bandwidth_gbs(device)
    if not gbs > 0:
        raise PhaseError(f"copy rate {gbs}")
    return (f"1 GiB copy {gbs:.1f} GB/s (read + write) vs data-sheet "
            f"{peak:.0f} GB/s = {gbs / peak:.3f}")


def phase_cli_spmv(ctx) -> str:
    from smvp_toolkit_tpu.utils.synth import parse_synth_spec

    spec = ctx["spec1"]
    with tempfile.TemporaryDirectory() as d:
        jpath = os.path.join(d, "run.jsonl")
        _run_cli(["-c", "-t", "--decode-check", "-n", "50", "-d", d,
                  "--x", f"random:{CLI_X_SEED}", "--json-out", jpath, spec])
        with open(jpath) as f:
            recs = {r["alg"]: r for r in map(json.loads, f)}
        y_csr = _report_vector(d, "CSR")
        y_tjds = _report_vector(d, "TJDS")
    coo = parse_synth_spec(spec)
    a = _scipy_csr(coo)
    ctx["coo1"], ctx["a1"] = coo, a
    y_ref = a @ cli_x(a.shape[1]).astype(np.float64)
    parts = [f"{spec} nnz={coo.nnz}"]
    for alg, y in (("CSR", y_csr), ("TJDS", y_tjds)):
        rec = recs[alg]
        parts.append(f"{alg}[{rec['kernel']}] {rec['nnz_per_s'] / 1e9:.2f} "
                     f"Gnnz/s {check('err', rel_max_err(y, y_ref), SPMV_TOL)}")
    return "; ".join(parts)


def poisson3d(m: int):
    """The 7-point Laplacian on an m³ grid (Dirichlet), scipy CSR."""
    import scipy.sparse as sp

    t = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], (m, m))
    e = sp.identity(m)
    return (sp.kron(sp.kron(t, e), e) + sp.kron(sp.kron(e, t), e)
            + sp.kron(sp.kron(e, e), t)).tocsr()


def phase_solve(ctx) -> str:
    import jax.numpy as jnp
    import scipy.sparse.linalg as spl

    from smvp_toolkit_tpu.formats.coo import COOMatrix
    from smvp_toolkit_tpu.formats.csr import csr_encode
    from smvp_toolkit_tpu.models import conjugate_gradient
    from smvp_toolkit_tpu.ops import spmv_csr, spmv_csr_cusparse

    a = poisson3d(ctx["poisson_edge"])
    coo = a.tocoo()
    csr = csr_encode(COOMatrix.from_numpy(coo.row, coo.col, coo.data,
                                          shape=a.shape))
    b = np.random.default_rng(0).standard_normal(a.shape[0])
    norm_b = np.linalg.norm(b)
    x64, _ = spl.cg(a, b, rtol=1e-30, atol=0.0, maxiter=CG_ITERS)
    r64 = np.linalg.norm(b - a @ x64) / norm_b
    parts = [f"poisson {ctx['poisson_edge']}^3 rows={a.shape[0]} "
             f"nnz={a.nnz} iters={CG_ITERS}"]
    bj = jnp.asarray(b, jnp.float32)
    for name, spmv in (("xla", spmv_csr), ("cusparse", spmv_csr_cusparse)):
        conjugate_gradient(csr, bj, num_iters=CG_ITERS,
                           spmv=spmv)[0].block_until_ready()
        t0 = time.perf_counter()
        x, _ = conjugate_gradient(csr, bj, num_iters=CG_ITERS, spmv=spmv)
        x.block_until_ready()
        ms = (time.perf_counter() - t0) * 1e3
        r32 = np.linalg.norm(b - a @ np.asarray(x, np.float64)) / norm_b
        parts.append(f"cg[{name}] {ms:.1f} ms {check_cg(r32, r64)}")
    return "; ".join(parts)


def phase_spmm_grad(ctx) -> str:
    import jax
    import jax.numpy as jnp

    from smvp_toolkit_tpu.formats.csr import csr_encode
    from smvp_toolkit_tpu.ops import spmm_csr, spmv_csr, spmv_csr_cusparse

    if "coo1" not in ctx:
        from smvp_toolkit_tpu.utils.synth import parse_synth_spec

        ctx["coo1"] = parse_synth_spec(ctx["spec1"])
        ctx["a1"] = _scipy_csr(ctx["coo1"])
    a = ctx["a1"]
    csr = csr_encode(ctx["coo1"].pad(128))
    rng = np.random.default_rng(1)
    xs = rng.standard_normal((a.shape[1], SPMM_K)).astype(np.float32)
    ys = np.asarray(spmm_csr(csr, jnp.asarray(xs)))
    parts = [f"rows={a.shape[0]} nnz={a.nnz} k={SPMM_K}",
             check("spmm err", rel_max_err(ys, a @ xs.astype(np.float64)),
                   SPMV_TOL)]

    g = rng.standard_normal(a.shape[0]).astype(np.float32)
    x = rng.standard_normal(a.shape[1]).astype(np.float32)
    row_ptr = np.asarray(csr.row_ptr)
    rows = np.repeat(np.arange(a.shape[0]), np.diff(row_ptr))
    cols = np.asarray(csr.col_ind)[:csr.nnz]
    ref_vals = g[rows].astype(np.float64) * x[cols]
    ref_x = a.T @ g.astype(np.float64)
    for name, spmv in (("xla", spmv_csr), ("cusparse", spmv_csr_cusparse)):
        # The matrix and g are arguments, not closure constants: XLA
        # would otherwise constant-fold index arithmetic over 23M entries.
        def loss(vals, xx, mat, gg, spmv=spmv):
            return jnp.vdot(gg, spmv(dataclasses.replace(mat, vals=vals), xx))

        gv, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(
            csr.vals, jnp.asarray(x), csr, jnp.asarray(g))
        parts.append(
            f"grad[{name}] "
            + check("d/dvals", rel_max_err(np.asarray(gv)[:csr.nnz],
                                           ref_vals), SPMV_TOL)
            + " " + check("d/dx", rel_max_err(gx, ref_x), SPMV_TOL))
    return "; ".join(parts)


def phase_four_cards(ctx) -> str:
    import jax
    import jax.numpy as jnp

    from smvp_toolkit_tpu.formats.csr import csr_encode
    from smvp_toolkit_tpu.ops import spmm_csr, spmv_csr
    from smvp_toolkit_tpu.parallel import (
        make_mesh,
        make_mesh_2d,
        shard_csr,
        shard_csr_2d,
        spmm_csr_sharded,
        spmv_csr_2d,
    )
    from smvp_toolkit_tpu.utils.synth import parse_synth_spec

    if len(jax.devices()) < 4:
        raise PhaseError(f"needs 4 devices, found {len(jax.devices())}")
    spec = ctx["spec4"]
    with tempfile.TemporaryDirectory() as d:
        x_arg = ["--x", f"random:{CLI_X_SEED}"]
        _run_cli(["-c", "--shards", "4", "--shard-balance", "nnz", "-n",
                  "20", "-d", d, *x_arg, spec])
        _run_cli(["-t", "--shards", "4", "-n", "20", "-d", d, *x_arg, spec])
        y_cli = {alg: _report_vector(d, alg) for alg in ("CSR", "TJDS")}
    coo = parse_synth_spec(spec).pad(512)
    csr = csr_encode(coo)
    n = coo.shape[0]
    y1 = np.asarray(spmv_csr(csr, jnp.asarray(cli_x(n))))
    parts = [f"{spec} nnz={coo.nnz} devices={len(jax.devices())}"]
    for alg in ("CSR", "TJDS"):
        parts.append(check(f"cli {alg} shards=4",
                           rel_max_err(y_cli[alg], y1), SPMV_TOL))

    rng = np.random.default_rng(2)
    x = jnp.asarray(rng.standard_normal(n).astype(np.float32))
    mesh2 = make_mesh_2d(2, 2)
    y2d = spmv_csr_2d(shard_csr_2d(csr, mesh2), x, mesh2)
    parts.append(check("2x2 mesh", rel_max_err(y2d, spmv_csr(csr, x)),
                       SPMV_TOL))

    xs = jnp.asarray(rng.standard_normal((n, SPMM_K)).astype(np.float32))
    mesh = make_mesh(4)
    ys = spmm_csr_sharded(shard_csr(csr, mesh), xs, mesh)
    parts.append(check(f"spmm k={SPMM_K} shards=4",
                       rel_max_err(ys, spmm_csr(csr, xs)), SPMV_TOL))
    return "; ".join(parts)


PHASES = {
    "device": (0, phase_device),
    "cli-spmv": (1, phase_cli_spmv),
    "solve": (2, phase_solve),
    "spmm-grad": (3, phase_spmm_grad),
    "four-cards": (4, phase_four_cards),
}


def default_context() -> dict:
    return {"spec1": PHASE1_SPEC, "spec4": PHASE4_SPEC,
            "poisson_edge": POISSON_EDGE}


def run_phases(names, ctx) -> bool:
    """Run ``names`` in order, one line each; True when all passed."""
    ok = True
    for name in names:
        num, fn = PHASES[name]
        t0 = time.perf_counter()
        try:
            detail = fn(ctx)
        except (Exception, SystemExit) as e:  # report, then fail the run
            ok = False
            print(f"phase {num} {name}: FAILED after "
                  f"{time.perf_counter() - t0:.1f} s: "
                  f"{type(e).__name__}: {e}", flush=True)
            continue
        print(f"phase {num} {name}: ok in {time.perf_counter() - t0:.1f} s: "
              f"{detail}", flush=True)
    return ok


def main(argv=None) -> int:
    args = parse_args(argv)
    from smvp_toolkit_tpu.bench.device import (
        NoGPUError,
        device_record,
        nvidia_smi_name_power,
        require_gpu,
    )
    from smvp_toolkit_tpu.utils.compile_cache import configure_compile_cache

    try:
        require_gpu()
    except NoGPUError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 1
    configure_compile_cache()
    print(f"nvidia-smi: {nvidia_smi_name_power()}", flush=True)
    if not run_phases(phases_for(args), default_context()):
        return 1
    print(json.dumps({"ok": True, "device": device_record()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
