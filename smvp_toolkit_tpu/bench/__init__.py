"""Benchmark harness: device-blocked timing, stats, roofline, reports.

Device re-design of the reference's timing layer (``_time_data_`` +
``clock_gettime(CLOCK_MONOTONIC_RAW)`` bracketing, main-cli.c:87-130,
396-456): warmup iterations absorb XLA compilation, every timed iteration
is bracketed by ``block_until_ready`` so device execution (not dispatch) is
measured, and derived GB/s / nnz/s / roofline-fraction metrics are
computed per BASELINE.json.
"""

from smvp_toolkit_tpu.bench.harness import (
    TimingStats,
    time_fn,
    bench_spmv,
    bench_spmv_fused,
    bench_native_batched,
)
from smvp_toolkit_tpu.bench.report import generate_report_text, write_report
from smvp_toolkit_tpu.bench.roofline import (
    hbm_bandwidth_gbs,
    roofline_fraction,
    spmv_bytes_csr,
    spmv_bytes_tjds,
    spmv_bytes_cisr,
)

__all__ = [
    "TimingStats",
    "time_fn",
    "bench_spmv",
    "bench_spmv_fused",
    "bench_native_batched",
    "generate_report_text",
    "write_report",
    "hbm_bandwidth_gbs",
    "roofline_fraction",
    "spmv_bytes_csr",
    "spmv_bytes_tjds",
    "spmv_bytes_cisr",
]
