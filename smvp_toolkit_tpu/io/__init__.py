"""Matrix I/O: MatrixMarket (.mtx) reading and writing.

Re-design of the reference's vendored NIST mmio library
(reference mmio/mmio.c:16-483, mmio/mmio.h:16-133): host-side parsing that
produces device-ready numpy/JAX arrays instead of fscanf triplet loops.
"""

from smvp_toolkit_tpu.io.mtx import (
    MMTypeCode,
    MTXError,
    MTXPrematureEOF,
    MTXNoHeader,
    MTXNotMatrix,
    MTXUnsupportedType,
    read_banner,
    read_mtx,
    read_mtx_raw,
    write_mtx,
)

__all__ = [
    "MMTypeCode",
    "MTXError",
    "MTXPrematureEOF",
    "MTXNoHeader",
    "MTXNotMatrix",
    "MTXUnsupportedType",
    "read_banner",
    "read_mtx",
    "read_mtx_raw",
    "write_mtx",
]
