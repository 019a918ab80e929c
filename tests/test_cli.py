"""CLI tests: flag surface, validation (main-cli.c:1274-1386 parity),
report emission, --all-algs actually running everything (§B1 fix)."""

import os
import re

import numpy as np
import pytest

from smvp_toolkit_tpu.cli import build_parser, main, _validate

from conftest import SAMPLE_DIR

IBM32 = os.path.join(SAMPLE_DIR, "ibm32.mtx")
PDP = os.path.join(SAMPLE_DIR, "pdp08-pg4.mtx")


# ---------------------------------------------------------------------------
# Validation parity
# ---------------------------------------------------------------------------


def _args(argv):
    return build_parser().parse_args(argv)


def test_all_algs_exclusive_with_individual():
    assert _validate(_args(["-a", "-c", "x.mtx"])) is not None
    assert _validate(_args(["-a", "x.mtx"])) is None


def test_no_alg_selected():
    assert _validate(_args(["x.mtx"])) is not None


def test_iteration_count_positive():
    assert _validate(_args(["-c", "-n", "0", "x.mtx"])) is not None
    assert _validate(_args(["-c", "-n", "5", "x.mtx"])) is None


def test_slot_count_range():
    assert _validate(_args(["-g", "-s", "0", "x.mtx"])) is not None
    assert _validate(_args(["-g", "-s", "256", "x.mtx"])) is not None
    assert _validate(_args(["-g", "-s", "16", "x.mtx"])) is None


def test_report_dir_must_exist():
    assert _validate(_args(["-c", "-d", "/nonexistent-dir-xyz", "x.mtx"])) is not None


# ---------------------------------------------------------------------------
# End-to-end runs (small iteration counts, XLA kernel on CPU)
# ---------------------------------------------------------------------------


def test_missing_file_error():
    assert main(["-c", "-n", "1", "/no/such/file.mtx"]) == 1


def test_bad_mtx_error():
    bad = os.path.join(SAMPLE_DIR, "badfile.mtx")
    assert main(["-c", "-n", "1", bad]) == 1


def test_csr_run_writes_report(tmp_path):
    rc = main(["-c", "-n", "3", "-d", str(tmp_path), "--kernel", "xla", IBM32])
    assert rc == 0
    reports = list(tmp_path.glob("smvp-toolbox_report_CSR_*.txt"))
    assert len(reports) == 1
    text = reports[0].read_text()
    assert "CSR algorithm" in text
    assert "Non-zero numbers contained in matrix: 126" in text
    assert "Compute times for 3 iterations:" in text
    # Output vector: 32 values inside [ ].
    vec = re.search(r"\[\n(.*?)\n\]", text, re.S).group(1).split()
    assert len(vec) == 32
    # ibm32 is a pattern matrix with x = ones: y = row counts, Σ = nnz.
    assert sum(float(v) for v in vec) == 126.0


def test_all_algs_runs_everything(tmp_path):
    # §B1 fix: --all-algs must actually run CSR + TJDS + CISR.
    coe = tmp_path / "out.coe"
    rc = main(
        ["-a", "-n", "2", "-d", str(tmp_path), "--kernel", "xla",
         "--coe-out", str(coe), PDP]
    )
    assert rc == 0
    assert list(tmp_path.glob("smvp-toolbox_report_CSR_*.txt"))
    assert list(tmp_path.glob("smvp-toolbox_report_TJDS_*.txt"))
    assert coe.exists()
    assert "memory_initialization_radix=16;" in coe.read_text()


def test_decode_check_flag(tmp_path):
    rc = main(
        ["-c", "-t", "-n", "1", "-d", str(tmp_path), "--kernel", "xla",
         "--decode-check", PDP]
    )
    assert rc == 0


def test_no_report_flag(tmp_path):
    rc = main(["-c", "-n", "1", "-d", str(tmp_path), "--kernel", "xla",
               "--no-report", IBM32])
    assert rc == 0
    assert not list(tmp_path.glob("*.txt"))


def test_csr_tjds_reports_agree(tmp_path):
    # The reference's own reports disagree (TJDS bug §B2); ours must agree.
    rc = main(["-c", "-t", "-n", "2", "-d", str(tmp_path), "--kernel", "xla",
               os.path.join(SAMPLE_DIR, "curtis54.mtx")])
    assert rc == 0
    vecs = []
    for pat in ["CSR", "TJDS"]:
        f = list(tmp_path.glob(f"smvp-toolbox_report_{pat}_*.txt"))[0]
        body = re.search(r"\[\n(.*?)\n\]", f.read_text(), re.S).group(1)
        vecs.append(np.array([float(t) for t in body.split()]))
    np.testing.assert_allclose(vecs[0], vecs[1], rtol=1e-5)
    assert vecs[0].sum() == 291.0  # = nnz for pattern matrix, x = ones


def test_interactive_mode(tmp_path):
    """The interactive front-end (working analog of the dead GUI stub)."""
    import io as _io

    from smvp_toolkit_tpu.interactive import main as interactive_main

    answers = f"{PDP}\ny\nn\n2\n{tmp_path}\n"
    rc = interactive_main(stdin=_io.StringIO(answers), stdout=_io.StringIO())
    assert rc == 0
    assert list(tmp_path.glob("smvp-toolbox_report_CSR_*.txt"))


def test_interactive_rejects_missing_file():
    import io as _io

    from smvp_toolkit_tpu.interactive import main as interactive_main

    rc = interactive_main(
        stdin=_io.StringIO("/does/not/exist.mtx\n\n"), stdout=_io.StringIO()
    )
    assert rc == 2


def test_launch_runner_cpu(capsys):
    """Distributed launch runner end-to-end on the virtual device mesh."""
    from smvp_toolkit_tpu.parallel.launch import main as launch_main

    rc = launch_main([PDP, "--alg", "csr", "-n", "2"])
    assert rc == 0


def test_launch_runner_synth():
    from smvp_toolkit_tpu.parallel.launch import main as launch_main

    rc = launch_main(["synth:1000:5000", "--alg", "tjds", "-n", "1"])
    assert rc == 0


def test_fused_timing_mode(tmp_path):
    rc = main(["-c", "-n", "5", "--fused", "-d", str(tmp_path),
               "--kernel", "xla", IBM32])
    assert rc == 0
    f = list(tmp_path.glob("smvp-toolbox_report_CSR_*.txt"))[0]
    assert "Compute times for 5 iterations:" in f.read_text()


@pytest.mark.parametrize("argv", [["--kernel", "pallas"],
                                  ["--kernel=pallas"], ["--cocluster"]])
def test_removed_sell_options_exit_2(argv, capsys):
    """Options of the removed SELL kernel are refused with one line and
    exit code 2, never remapped to another kernel."""
    assert main(["-c", "-n", "1", *argv, PDP]) == 2
    out = capsys.readouterr()
    lines = (out.out + out.err).strip().splitlines()
    assert len(lines) == 1 and "removed" in lines[0]


@pytest.mark.parametrize("platform,dtype,kernel", [
    ("gpu", "float32", "cusparse"),
    ("gpu", "complex64", "cusparse"),
    ("gpu", "bfloat16", "xla"),
    ("cpu", "float32", "xla"),
])
def test_auto_kernel_choice(platform, dtype, kernel):
    """--kernel auto: cuSPARSE on a GPU for the dtypes it takes, the XLA
    kernel otherwise."""
    import jax.numpy as jnp

    from smvp_toolkit_tpu.ops import (
        csr_spmv_for,
        spmv_csr,
        spmv_csr_cusparse,
    )

    label, fn = csr_spmv_for(platform, jnp.dtype(dtype))
    assert label == kernel
    assert fn is {"cusparse": spmv_csr_cusparse, "xla": spmv_csr}[kernel]


def test_fused_excludes_shards():
    assert _validate(_args(["-c", "--fused", "--shards", "2", "x.mtx"])) is not None


def test_output_flags_require_their_algorithm():
    assert _validate(_args(["-c", "--lut-out", "l.v", "x.mtx"])) is not None
    assert _validate(_args(["-t", "--lut-out", "l.v", "x.mtx"])) is None
    assert _validate(_args(["-g", "--save-encoded", "p", "x.mtx"])) is not None
    assert _validate(_args(["-g", "--decode-check", "x.mtx"])) is not None


def test_interactive_eof_on_real_stdin_pattern():
    # EOF must abort, not busy-loop (regression).
    import io as _io

    from smvp_toolkit_tpu.interactive import main as interactive_main

    rc = interactive_main(stdin=_io.StringIO(""), stdout=_io.StringIO())
    assert rc == 2


def test_native_kernel_mode(tmp_path):
    from smvp_toolkit_tpu.ops.spmv_native import native_spmv_available

    if not native_spmv_available():
        import pytest

        pytest.skip("libspmv.so not built")
    rc = main(["-c", "-n", "2", "--kernel", "native", "-d", str(tmp_path),
               IBM32])
    assert rc == 0
    f = list(tmp_path.glob("smvp-toolbox_report_CSR_*.txt"))[0]
    body = re.search(r"\[\n(.*?)\n\]", f.read_text(), re.S).group(1)
    assert sum(float(t) for t in body.split()) == 126.0


def test_sharded_nnz_balance_via_cli(tmp_path):
    rc = main(["-c", "-n", "2", "--shards", "4", "--shard-balance", "nnz",
               "-d", str(tmp_path), os.path.join(SAMPLE_DIR, "curtis54.mtx")])
    assert rc == 0
    f = list(tmp_path.glob("smvp-toolbox_report_CSR_*.txt"))[0]
    body = re.search(r"\[\n(.*?)\n\]", f.read_text(), re.S).group(1)
    assert sum(float(t) for t in body.split()) == 291.0


def test_fused_native_kernel_batches(tmp_path):
    """--fused --kernel native runs the batched C loop instead of trying
    to trace ctypes inside a fori_loop (round-1 advisor finding)."""
    from smvp_toolkit_tpu.ops.spmv_native import native_spmv_available

    if not native_spmv_available():
        pytest.skip("libspmv.so not built")
    rc = main(["-c", "-t", "-n", "8", "--fused", "--kernel", "native",
               "-d", str(tmp_path), IBM32])
    assert rc == 0
    f = list(tmp_path.glob("smvp-toolbox_report_CSR_*.txt"))[0]
    body = re.search(r"\[\n(.*?)\n\]", f.read_text(), re.S).group(1)
    assert sum(float(t) for t in body.split()) == 126.0


def test_sharded_native_reports_actual_kernel(tmp_path):
    """--shards with --kernel native benchmarks XLA; the report must say
    so (round-1 advisor finding: misattributed kernel label)."""
    from smvp_toolkit_tpu.ops.spmv_native import native_spmv_available

    if not native_spmv_available():
        pytest.skip("libspmv.so not built")
    rc = main(["-c", "-n", "2", "--shards", "2", "--kernel", "native",
               "-d", str(tmp_path), IBM32])
    assert rc == 0
    f = list(tmp_path.glob("smvp-toolbox_report_CSR_*.txt"))[0]
    text = f.read_text()
    assert "Kernel: xla" in text
    assert "Kernel: native" not in text


def test_fused_bfloat16_accumulates(tmp_path):
    """--fused with --dtype bfloat16 keeps the loop carry in the
    kernel's output dtype (no carry-dtype mismatch)."""
    rc = main(["-c", "-n", "2", "--fused", "--kernel", "xla",
               "--dtype", "bfloat16", "-d", str(tmp_path), IBM32])
    assert rc == 0
    f = list(tmp_path.glob("smvp-toolbox_report_CSR_*.txt"))[0]
    body = re.search(r"\[\n(.*?)\n\]", f.read_text(), re.S).group(1)
    assert sum(float(t) for t in body.split()) == 126.0


def test_df64_kernel_mode(tmp_path):
    """--kernel df64 runs the double-float CSR path end to end."""
    rc = main(["-c", "-t", "-n", "2", "--kernel", "df64", "-d",
               str(tmp_path), IBM32])
    assert rc == 0
    f = list(tmp_path.glob("smvp-toolbox_report_CSR_*.txt"))[0]
    text = f.read_text()
    assert "Kernel: df64" in text
    body = re.search(r"\[\n(.*?)\n\]", text, re.S).group(1)
    assert sum(float(t) for t in body.split()) == 126.0


def test_x_random_mode_csr_tjds_agree(tmp_path):
    """--x random: CSR and TJDS must produce the same y for general x
    (the reference's TJDS could not — SURVEY.md B4)."""
    rc = main(["-c", "-t", "-n", "2", "--x", "random:7", "-d",
               str(tmp_path), os.path.join(SAMPLE_DIR, "curtis54.mtx")])
    assert rc == 0
    vecs = []
    for alg in ("CSR", "TJDS"):
        f = list(tmp_path.glob(f"smvp-toolbox_report_{alg}_*.txt"))[0]
        body = re.search(r"\[\n(.*?)\n\]", f.read_text(), re.S).group(1)
        vecs.append([float(t) for t in body.split()])
    np.testing.assert_allclose(vecs[0], vecs[1], rtol=1e-4, atol=1e-5)


def test_x_mode_validation():
    assert main(["-c", "-n", "1", "--x", "bogus",
                 os.path.join(SAMPLE_DIR, "ibm32.mtx")]) == 2


def test_synth_input_spec(tmp_path):
    """synth:N:NNZ inputs run the full pipeline without a file."""
    rc = main(["-c", "-n", "2", "--no-report", "synth:1000:5000"])
    assert rc == 0
    assert main(["-c", "-n", "1", "synth:bad"]) == 2


def test_json_out_records(tmp_path):
    import json

    from smvp_toolkit_tpu.cli import main as cli_main

    out = tmp_path / "metrics.jsonl"
    rc = cli_main(
        ["-c", "-t", "-n", "2", "--no-report", "--json-out", str(out),
         os.path.join(SAMPLE_DIR, "curtis54.mtx")]
    )
    assert rc == 0
    recs = [json.loads(l) for l in out.read_text().splitlines()]
    assert [r["alg"] for r in recs] == ["CSR", "TJDS"]
    for r in recs:
        assert r["nnz"] == 291 and r["iterations"] == 2
        assert r["avg_ms"] > 0 and r["nnz_per_s"] > 0
        assert "kernel" in r and "device" in r


@pytest.mark.parametrize("method", ["cg", "pcg", "bicgstab", "gmres",
                                    "minres", "chebyshev",
                                    "bicgstab-ilu"])
def test_solve_mode_runs(method, tmp_path):
    """--solve reports a finite residual and writes a SOLVE report.

    pdp08-pg4 is tiny and square; Krylov methods may not converge on a
    nonsymmetric system in few iters — the contract here is the plumbing
    (flag parse, solve, residual log, report), convergence is covered by
    tests/test_models.py.
    """
    import json

    from smvp_toolkit_tpu.cli import main as cli_main

    out = tmp_path / "m.jsonl"
    rc = cli_main(
        ["-c", "-n", "1", "-d", str(tmp_path),
         "--solve", f"{method}:12", "--json-out", str(out),
         os.path.join(SAMPLE_DIR, "pdp08-pg4.mtx")]
    )
    assert rc == 0
    recs = [json.loads(l) for l in out.read_text().splitlines()]
    solve = [r for r in recs if r["alg"].startswith("SOLVE-")]
    assert len(solve) == 1 and np.isfinite(solve[0]["relative_residual"])
    reports = list(tmp_path.glob("*SOLVE*"))
    assert len(reports) == 1


def test_solve_pcg_ic0_on_spd_system(tmp_path):
    """--solve pcg-ic0 CONVERGES on an SPD input (its intended domain).

    pdp08-pg4 (the plumbing fixture above) is nonsymmetric, which an
    incomplete-Cholesky CG is not for — so this method gets a real SPD
    system: a 2-D Poisson matrix written as a symmetric .mtx.
    """
    import json

    from smvp_toolkit_tpu.cli import main as cli_main

    nx = 8
    n = nx * nx
    lines = []
    for i in range(nx):
        for j in range(nx):
            k = i * nx + j
            lines.append((k, k, 4.0))
            if i > 0:
                lines.append((k, k - nx, -1.0))
            if j > 0:
                lines.append((k, k - 1, -1.0))
    mtx = tmp_path / "poisson.mtx"
    mtx.write_text(
        "%%MatrixMarket matrix coordinate real symmetric\n"
        f"{n} {n} {len(lines)}\n"
        + "".join(f"{r + 1} {c + 1} {v}\n" for r, c, v in lines)
    )
    out = tmp_path / "m.jsonl"
    rc = cli_main(
        ["-c", "-n", "1", "-d", str(tmp_path), "--expand-symmetry",
         "--solve", "pcg-ic0:30:1e-5", "--json-out", str(out),
         str(mtx)]
    )
    assert rc == 0
    recs = [json.loads(l) for l in out.read_text().splitlines()]
    solve = [r for r in recs if r["alg"] == "SOLVE-PCG-IC0"]
    assert len(solve) == 1
    assert solve[0]["relative_residual"] < 1e-4


@pytest.mark.parametrize("method", ["cg-fused", "pcg-ic0-fused",
                                    "chebyshev-fused"])
def test_removed_fused_solve_methods_rejected(method):
    """The one-launch solver kernels were removed; their methods are
    usage errors now."""
    assert main(["-c", "-n", "1", "--solve", f"{method}:8", PDP]) == 2


def test_solve_validation():
    from smvp_toolkit_tpu.cli import main as cli_main

    f = os.path.join(SAMPLE_DIR, "pdp08-pg4.mtx")
    assert cli_main(["-t", "--solve", "cg", f]) == 2  # needs CSR
    assert cli_main(["-c", "--solve", "sor", f]) == 2  # unknown method
    assert cli_main(["-c", "--solve", "cg:x", f]) == 2  # bad iters


def test_solve_complex_system(tmp_path):
    """--solve on a complex matrix solves in complex64 (no dtype crash)."""
    from smvp_toolkit_tpu.cli import main as cli_main

    mtx = tmp_path / "c.mtx"
    mtx.write_text(
        "%%MatrixMarket matrix coordinate complex general\n"
        "2 2 3\n1 1 4.0 0.0\n2 2 5.0 1.0\n1 2 1.0 0.5\n"
    )
    rc = cli_main(["-c", "-n", "1", "--no-report", "--solve", "gmres:8",
                   str(mtx)])
    assert rc == 0
    # chebyshev needs a real SPD system -> clean validation error
    rc = cli_main(["-c", "-n", "1", "--no-report", "--solve",
                   "chebyshev:8", str(mtx)])
    assert rc == 2


@pytest.mark.parametrize("method", ["pcg-cheb", "pcg-neumann"])
def test_solve_polynomial_preconditioned(method, tmp_path):
    """--solve pcg-cheb/pcg-neumann converge on an SPD system."""
    import json

    from smvp_toolkit_tpu.cli import main as cli_main
    from smvp_toolkit_tpu.io.mtx import write_mtx

    rng = np.random.RandomState(3)
    n = 40
    a = np.zeros((n, n))
    for _ in range(3 * n):
        i, j = rng.randint(0, n, 2)
        w = rng.rand()
        a[i, j] += w
        a[j, i] += w
    a += np.diag(np.abs(a).sum(axis=1) + 1.0)
    r, c = np.nonzero(a)
    path = tmp_path / "spd.mtx"
    write_mtx(str(path), r.astype(np.int32), c.astype(np.int32),
              a[r, c], (n, n))

    out = tmp_path / "m.jsonl"
    rc = cli_main(
        ["-c", "-n", "1", "-d", str(tmp_path),
         "--solve", f"{method}:20", "--json-out", str(out), str(path)]
    )
    assert rc == 0
    recs = [json.loads(l) for l in out.read_text().splitlines()]
    solve = [r for r in recs if r["alg"].startswith("SOLVE-")]
    assert len(solve) == 1
    assert solve[0]["relative_residual"] < 1e-3


def test_solve_tol_spec(tmp_path):
    """--solve cg:ITERS:TOL parses, early-stops, and rejects bad tols."""
    import json

    from smvp_toolkit_tpu.cli import main as cli_main
    from smvp_toolkit_tpu.io.mtx import write_mtx

    rng = np.random.RandomState(11)
    n = 40
    a = np.zeros((n, n))
    for _ in range(3 * n):
        i, j = rng.randint(0, n, 2)
        w = rng.rand()
        a[i, j] += w
        a[j, i] += w
    a += np.diag(np.abs(a).sum(axis=1) + 1.0)
    r, c = np.nonzero(a)
    path = tmp_path / "spd.mtx"
    write_mtx(str(path), r.astype(np.int32), c.astype(np.int32),
              a[r, c], (n, n))

    out = tmp_path / "m.jsonl"
    rc = cli_main(
        ["-c", "-n", "1", "-d", str(tmp_path),
         "--solve", "cg:100:1e-4", "--json-out", str(out), str(path)]
    )
    assert rc == 0
    recs = [json.loads(l) for l in out.read_text().splitlines()]
    solve = [r2 for r2 in recs if r2["alg"].startswith("SOLVE-")]
    assert len(solve) == 1
    assert solve[0]["relative_residual"] < 1e-3
    # the ACHIEVED (early-stopped) count is recorded, not the requested
    assert 0 < solve[0]["iterations"] < 100

    # bad tolerance strings are usage errors (rc 2)
    for bad in ("cg:100:0", "cg:100:2", "cg:100:x", "cg:1:2:3"):
        assert cli_main(
            ["-c", "-n", "1", "--no-report", "--solve", bad, str(path)]
        ) == 2


def test_spmm_flag(tmp_path):
    """--spmm K benchmarks the multi-RHS SpMM and records a JSON line;
    bad K or a missing CSR selection are usage errors."""
    import json

    from smvp_toolkit_tpu.cli import main as cli_main

    f = os.path.join(SAMPLE_DIR, "curtis54.mtx")
    out = tmp_path / "spmm.jsonl"
    rc = cli_main(["-c", "-n", "2", "--spmm", "4", "--no-report",
                   "--json-out", str(out), f])
    assert rc == 0
    recs = [json.loads(l) for l in out.read_text().splitlines()]
    spmm = [r for r in recs if r["alg"] == "SPMM-CSR"]
    assert len(spmm) == 1 and spmm[0]["k"] == 4
    assert spmm[0]["nnz_per_s_krhs"] > 0

    # fused timing mode composes
    assert cli_main(["-c", "-n", "2", "--spmm", "2", "--fused",
                     "--no-report", f]) == 0
    # usage errors
    assert cli_main(["-t", "-n", "1", "--spmm", "4", "--no-report", f]) == 2
    assert cli_main(["-c", "-n", "1", "--spmm", "0", "--no-report", f]) == 2
