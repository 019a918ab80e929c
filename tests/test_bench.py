"""Benchmark harness + report writer + roofline accounting tests."""

import os
import re

import numpy as np

from smvp_toolkit_tpu.bench.harness import TimingStats, time_fn
from smvp_toolkit_tpu.bench.report import generate_report_text, write_report
from smvp_toolkit_tpu.bench.roofline import (
    hbm_bandwidth_gbs,
    roofline_fraction,
    spmv_bytes_csr,
    spmv_bytes_tjds,
)

from conftest import SAMPLE_DIR


def test_stats_reduction():
    # Analog of the reference reduction main-cli.c:428-456.
    s = TimingStats(times_ms=np.array([1.0, 2.0, 3.0, 4.0]), iterations=4)
    assert s.total_ms == 10.0
    assert s.avg_ms == 2.5
    assert s.min_ms == 1.0
    assert s.max_ms == 4.0
    np.testing.assert_allclose(s.stdev_ms, np.std([1, 2, 3, 4]))
    assert s.nnz_per_s(1000) == 1000 / 2.5e-3
    assert s.gb_per_s(2.5e6) == 1.0


def test_time_fn_counts():
    import jax.numpy as jnp

    calls = []

    def fn():
        calls.append(1)
        return jnp.zeros(4)

    stats = time_fn(fn, iterations=5, warmup=2)
    assert stats.iterations == 5
    assert len(stats.times_ms) == 5
    assert len(calls) == 7  # warmup + timed
    assert (stats.times_ms > 0).all()


def test_time_fn_inner_amortization():
    import jax.numpy as jnp

    stats = time_fn(lambda: jnp.zeros(4), iterations=3, warmup=1, inner=4)
    assert len(stats.times_ms) == 3


def test_fused_device_loop_matches_reference_semantics():
    # N sequential SpMVs inside one program; result must equal N * (A @ x).
    import jax.numpy as jnp

    from smvp_toolkit_tpu.bench.harness import bench_spmv_fused
    from smvp_toolkit_tpu.formats.coo import COOMatrix
    from smvp_toolkit_tpu.formats.csr import csr_encode
    from smvp_toolkit_tpu.ops import spmv_csr

    r = np.array([0, 1, 2], dtype=np.int32)
    c = np.array([1, 0, 2], dtype=np.int32)
    v = np.array([2.0, 3.0, 4.0])
    coo = COOMatrix.from_numpy(r, c, v, shape=(3, 3), pad_to=8)
    csr = csr_encode(coo)
    x = jnp.ones((3,), jnp.float32)
    stats = bench_spmv_fused(spmv_csr, csr, x, iterations=10, repeats=3)
    assert stats.iterations == 10
    assert len(stats.times_ms) == 10  # one sample per reported iteration
    assert (stats.times_ms > 0).all()


def test_report_format_matches_reference():
    # Section order per main-cli.c:294-317.
    stats = TimingStats(times_ms=np.array([0.5, 0.7]), iterations=2)
    text = generate_report_text(
        alg_name="CSR",
        input_file="./sample-data/ibm32.mtx",
        nnz=126,
        iterations=2,
        stats=stats,
        output_vector=np.array([6.0, 6.0, 8.0]),
        unix_time=1615284655,
    )
    lines = text.splitlines()
    assert lines[0].endswith("CSR algorithm")
    assert lines[1] == "Generated on 1615284655 (Unix time)"
    assert "Sparse matrix file in use:" in lines
    assert "Non-zero numbers contained in matrix: 126" in lines
    assert "Compute times for 2 iterations:" in lines
    assert "Total Time: 1.2 ms" in lines
    assert "Average Time: 0.6 ms" in lines
    assert "Fastest Time: 0.5 ms" in lines
    assert "Slowest Time: 0.7 ms" in lines
    assert any(ln.startswith("Time StDev: 0.1 ms") for ln in lines)
    i = lines.index("[")
    assert lines[i + 1 : i + 4] == ["6", "6", "8"]
    assert lines[i + 4] == "]"


def test_g_formatting():
    # %g semantics: 6 significant digits, exponent switch like C.
    stats = TimingStats(times_ms=np.array([0.0004319]), iterations=1)
    text = generate_report_text(
        alg_name="CSR",
        input_file="f",
        nnz=1,
        iterations=1,
        stats=stats,
        output_vector=np.array([1234567.0, 0.000012345]),
    )
    assert "Average Time: 0.0004319 ms" in text
    assert "1.23457e+06" in text
    assert "1.2345e-05" in text


def test_write_report_filename(tmp_path):
    stats = TimingStats(times_ms=np.array([1.0]), iterations=1)
    path = write_report(
        str(tmp_path),
        alg_name="TJDS",
        input_file="x.mtx",
        nnz=5,
        iterations=1,
        stats=stats,
        output_vector=np.zeros(2),
    )
    assert re.match(r".*smvp-toolbox_report_TJDS_\d+\.txt$", path)
    assert (tmp_path / path.split("/")[-1]).exists()


def test_extra_metrics_block():
    stats = TimingStats(times_ms=np.array([1.0]), iterations=1)
    text = generate_report_text(
        alg_name="CSR",
        input_file="f",
        nnz=1,
        iterations=1,
        stats=stats,
        output_vector=np.zeros(1),
        extra_metrics={"nnz/s": "1e9"},
    )
    assert "Device metrics:" in text
    assert "nnz/s: 1e9" in text


def test_byte_accounting():
    # CSR: nnz*(val+col+x) + rows*(ptr+y) with f32 values.
    assert spmv_bytes_csr(100, 10, 4) == 100 * 12 + 10 * 8
    assert spmv_bytes_tjds(100, 10, 5, 4) == 100 * 12 + 6 * 4 + 10 * 4


def test_roofline_positive():
    bw = hbm_bandwidth_gbs()
    assert bw > 0
    assert roofline_fraction(bw / 2) == 0.5


def test_fused_stats_match_report_semantics():
    # Total Time must be ~iterations x avg, not the repeat-sample sum.
    import jax.numpy as jnp

    from smvp_toolkit_tpu.bench.harness import bench_spmv_fused
    from smvp_toolkit_tpu.formats.coo import COOMatrix
    from smvp_toolkit_tpu.formats.csr import csr_encode
    from smvp_toolkit_tpu.ops import spmv_csr

    r = np.array([0, 1], dtype=np.int32)
    c = np.array([0, 1], dtype=np.int32)
    coo = COOMatrix.from_numpy(r, c, np.ones(2), shape=(2, 2), pad_to=8)
    csr = csr_encode(coo)
    stats = bench_spmv_fused(
        spmv_csr, csr, jnp.ones((2,), jnp.float32), iterations=50, repeats=3
    )
    assert len(stats.times_ms) == 50
    np.testing.assert_allclose(stats.total_ms, 50 * stats.avg_ms, rtol=1e-6)


def test_bench_native_batched_and_per_launch_label(tmp_path):
    """bench_native_batched batches iterations inside the C loop and marks
    the stats per-launch; the report labels the extrema accordingly."""
    import numpy as np

    from smvp_toolkit_tpu.bench import generate_report_text
    from smvp_toolkit_tpu.bench.harness import bench_native_batched
    from smvp_toolkit_tpu.formats.csr import csr_encode
    from smvp_toolkit_tpu.io.mtx import read_mtx
    from smvp_toolkit_tpu.ops.spmv_native import (
        NativeCsrSpMV,
        native_spmv_available,
    )

    if not native_spmv_available():
        import pytest

        pytest.skip("libspmv.so not built")
    coo = read_mtx(os.path.join(SAMPLE_DIR, "ibm32.mtx")).pad(128)
    op = NativeCsrSpMV(csr_encode(coo))
    x = np.ones(coo.shape[1], dtype=np.float32)
    stats = bench_native_batched(op, x, iterations=64, repeats=4)
    assert stats.per_launch
    assert stats.times_ms.shape == (64,)
    assert stats.avg_ms > 0
    text = generate_report_text(
        alg_name="CSR", input_file="x.mtx", nnz=coo.nnz, iterations=64,
        stats=stats, output_vector=np.zeros(4),
    )
    assert "per-launch averages" in text


def test_fused_return_final_accumulator():
    # return_final rides validation on the timing loop's own compile:
    # acc must equal iterations * (A @ x) bit-for-bit in f32 order.
    import jax.numpy as jnp

    from smvp_toolkit_tpu.bench.harness import bench_spmv_fused
    from smvp_toolkit_tpu.formats.coo import COOMatrix
    from smvp_toolkit_tpu.formats.csr import csr_encode
    from smvp_toolkit_tpu.ops import spmv_csr

    r = np.array([0, 1, 2, 2], dtype=np.int32)
    c = np.array([1, 0, 2, 0], dtype=np.int32)
    v = np.array([2.0, 3.0, 4.0, -1.5])
    coo = COOMatrix.from_numpy(r, c, v, shape=(3, 3), pad_to=8)
    csr = csr_encode(coo)
    x = jnp.arange(1.0, 4.0, dtype=jnp.float32)
    stats, acc = bench_spmv_fused(
        spmv_csr, csr, x, iterations=7, repeats=2, return_final=True
    )
    y = np.asarray(spmv_csr(csr, x))
    np.testing.assert_allclose(np.asarray(acc), 7 * y, rtol=1e-6)
    assert stats.iterations == 7


def _bench_module():
    import importlib
    import os
    import sys as _sys

    _sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    return importlib.import_module("bench")


def test_bench_refuses_cpu(capsys):
    """Off the GPU bench.py fails and prints no result line."""
    bench = _bench_module()
    assert bench.main() != 0
    out = capsys.readouterr()
    assert out.out.strip() == ""
    assert "no GPU" in out.err


def test_bench_measure_record_on_small_matrix():
    """measure() checks y against scipy, then reports the route and the
    device it ran on (here the CPU, with the XLA kernel)."""
    bench = _bench_module()
    rec = bench.measure("synth:3000:30000")
    assert rec["platform"] == "cpu" and rec["kernel"] == "xla"
    assert rec["device_kind"] and rec["device_count"] >= 1
    assert rec["max_rel_err"] <= bench.TOL
    for key in ("nnz_per_s", "eff_gb_s", "roofline_frac", "median_ms"):
        assert rec[key] > 0


def test_roofline_peak_table_keyed_by_device_kind():
    """The H100's exact device_kind maps to its data-sheet peak; an
    unknown accelerator raises instead of borrowing another's peak."""
    import pytest

    from smvp_toolkit_tpu.bench.roofline import (
        PEAK_HBM_GBS,
        UnknownDeviceError,
    )

    class _Dev:
        def __init__(self, kind, platform):
            self.device_kind, self.platform = kind, platform

    assert hbm_bandwidth_gbs(_Dev("NVIDIA H100 80GB HBM3", "gpu")) == 3350.0
    assert PEAK_HBM_GBS["NVIDIA H100 80GB HBM3"] == 3350.0
    with pytest.raises(UnknownDeviceError):
        hbm_bandwidth_gbs(_Dev("Some Future GPU", "gpu"))
    with pytest.raises(UnknownDeviceError):
        roofline_fraction(1.0, _Dev("NVIDIA H100 PCIe", "gpu"))


def test_compile_cache_dir(monkeypatch, tmp_path):
    """JAX_COMPILATION_CACHE_DIR wins untouched; otherwise the cache is
    the checkout's fixed, gitignored .jax_cache."""
    import os

    import jax

    from smvp_toolkit_tpu.utils import compile_cache as cc

    before = jax.config.jax_compilation_cache_dir
    try:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        jax.config.update("jax_compilation_cache_dir", None)
        assert cc.configure_compile_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir is None  # JAX's own read

        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
        assert cc.configure_compile_cache() == cc.DEFAULT_CACHE_DIR
        assert jax.config.jax_compilation_cache_dir == cc.DEFAULT_CACHE_DIR
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        assert cc.DEFAULT_CACHE_DIR == os.path.join(root, ".jax_cache")
        with open(os.path.join(root, ".gitignore")) as f:
            assert ".jax_cache/" in f.read().split()
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
