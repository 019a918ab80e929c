"""Roofline accounting: bytes moved per SpMV and device memory peaks.

SpMV is memory-bound (≈0.1 FLOP/byte), so its roofline is bytes/iter ÷
the device's memory bandwidth, and ``roofline_frac`` is the share of that
bound a run reached.

Byte accounting follows BASELINE.md footnote 1 (~20 B/nnz for f64 CSR):
here parameterized by dtype — per nnz one value + one int32 index + one
x-gather; row_ptr/start_pos and the y write are amortized terms.
"""

from __future__ import annotations

import jax

__all__ = [
    "UnknownDeviceError",
    "hbm_bandwidth_gbs",
    "spmv_bytes_csr",
    "spmv_bytes_tjds",
    "spmv_bytes_cisr",
    "roofline_fraction",
]

# Published memory bandwidth (GB/s), keyed by the exact ``device_kind``
# JAX reports, with the source of each figure. A device that is not here
# is an error, never a default.
PEAK_HBM_GBS = {
    # NVIDIA H100 Tensor Core GPU data sheet, SXM5 part: 80 GB HBM3 at
    # 3.35 TB/s.
    "NVIDIA H100 80GB HBM3": 3350.0,
    # Nominal DRAM figure for CPU-backend test runs only; no CPU number
    # is reported as a device rate.
    "cpu": 50.0,
}


class UnknownDeviceError(LookupError):
    """The device has no entry in :data:`PEAK_HBM_GBS`."""


def hbm_bandwidth_gbs(device=None) -> float:
    """Published memory bandwidth of ``device`` (default: the first)."""
    if device is None:
        device = jax.devices()[0]
    kind = device.device_kind
    if kind in PEAK_HBM_GBS:
        return PEAK_HBM_GBS[kind]
    if device.platform == "cpu":
        return PEAK_HBM_GBS["cpu"]
    raise UnknownDeviceError(
        f"no memory-bandwidth peak for device_kind {kind!r} "
        f"(platform {device.platform}); add it to PEAK_HBM_GBS with "
        "its source"
    )


def _isz() -> int:
    return 4  # int32 indices throughout


def spmv_bytes_csr(nnz: int, nrows: int, value_bytes: int = 4) -> float:
    """Bytes touched per CSR SpMV iteration.

    val + col_ind + x-gather per nnz; row_ptr read + y write per row.
    """
    return nnz * (value_bytes + _isz() + value_bytes) + nrows * (
        _isz() + value_bytes
    )


def spmv_bytes_tjds(nnz: int, nrows: int, ndiags: int, value_bytes: int = 4) -> float:
    """Bytes touched per TJDS SpMV iteration.

    val + row_ind + x-stream per nnz; start_pos per diagonal; y write per
    row (the x permutation is a one-time encode cost, not per-iteration).
    """
    return (
        nnz * (value_bytes + _isz() + value_bytes)
        + (ndiags + 1) * _isz()
        + nrows * value_bytes
    )


def spmv_bytes_cisr(
    num_groups: int, slot_count: int, nrows: int, value_bytes: int = 4
) -> float:
    """Bytes touched per CISR-schedule SpMV iteration.

    Every beat×slot cell is read (val + col + row_of + x-gather),
    including the zero padding of idle channels — that traffic is the
    cost of the interleaved layout; y write per row. ``row_of`` is the
    kernel's reduction key (spmv_cisr.CisrSpMV streams it alongside the
    values), the analog of CSR's row_ptr read.
    """
    cells = num_groups * slot_count
    return (
        cells * (value_bytes + 2 * _isz() + value_bytes)
        + nrows * value_bytes
    )


def roofline_fraction(gbs: float, device=None) -> float:
    return gbs / hbm_bandwidth_gbs(device)
