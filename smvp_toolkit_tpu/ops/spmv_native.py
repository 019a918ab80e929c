"""Native CPU SpMV backend (ctypes binding to native/spmv.cpp).

The framework's native CPU execution path: the
reference's CSR traversal compiled -O3 -march=native, serial or
row-block threaded. Complements (does not replace) the portable XLA
CPU path — callers choose explicitly (`--kernel native`).
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional

import numpy as np

from smvp_toolkit_tpu.formats.csr import CSRMatrix

__all__ = [
    "native_spmv_available",
    "NativeCsrSpMV",
    "NativeTjdsSpMV",
    "spmv_csr_native",
    "spmv_tjds_native",
]

_LIB = None
_LIB_FAILED = False
_LOCK = threading.Lock()


def _load():
    global _LIB, _LIB_FAILED
    with _LOCK:
        if _LIB is not None:
            return _LIB
        if _LIB_FAILED:
            return None
        here = os.path.dirname(os.path.abspath(__file__))
        path = os.path.abspath(os.path.join(here, "..", "native", "libspmv.so"))
        if not os.path.exists(path):
            _LIB_FAILED = True
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:  # pragma: no cover
            _LIB_FAILED = True
            return None
        lib.csr_spmv_f32.restype = None
        lib.csr_spmv_f32.argtypes = [
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
            ctypes.c_longlong,
            ctypes.c_int,
            ctypes.c_int,
        ]
        lib.tjds_spmv_f32.restype = None
        lib.tjds_spmv_f32.argtypes = [
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
            ctypes.c_longlong,
            ctypes.c_longlong,
            ctypes.c_int,
            ctypes.c_int,
        ]
        _LIB = lib
        return lib


def native_spmv_available() -> bool:
    return _load() is not None


class NativeCsrSpMV:
    """Encoded CSR operator on the native CPU backend.

    ``threads=None`` uses all cores (capped at 16); ``threads=1``
    reproduces the reference's serial loop exactly.
    """

    def __init__(self, csr: CSRMatrix, threads: Optional[int] = None):
        lib = _load()
        if lib is None:
            raise RuntimeError(
                "libspmv.so not built (make -C smvp_toolkit_tpu/native)"
            )
        self._lib = lib
        self.shape = csr.shape
        self.nnz = csr.nnz
        self.row_ptr = np.ascontiguousarray(
            np.asarray(csr.row_ptr), dtype=np.int64
        )
        self.col = np.ascontiguousarray(
            np.asarray(csr.col_ind)[: csr.nnz], dtype=np.int32
        )
        self.val = np.ascontiguousarray(
            np.asarray(csr.vals)[: csr.nnz], dtype=np.float32
        )
        if threads is None:
            # Thread spawn costs ~25 us each; below ~32k nnz the serial
            # loop wins outright.
            cpus = os.cpu_count() or 1
            threads = 1 if csr.nnz < 32768 else cpus
        self.threads = min(threads, 16)

    def __call__(self, x, iterations: int = 1) -> np.ndarray:
        x = np.ascontiguousarray(np.asarray(x), dtype=np.float32)
        if x.shape[0] < self.shape[1]:
            raise ValueError("x too short")
        y = np.zeros(self.shape[0], dtype=np.float32)
        self._lib.csr_spmv_f32(
            self.row_ptr, self.col, self.val, x, y,
            self.shape[0], self.threads, iterations,
        )
        return y


def spmv_csr_native(csr: CSRMatrix, x) -> np.ndarray:
    """One-shot native CSR SpMV (builds the operator each call)."""
    return NativeCsrSpMV(csr)(x)


class NativeTjdsSpMV:
    """Encoded TJDS operator on the native CPU backend.

    The jagged-diagonal traversal of the reference hot loop
    (main-cli.c:1013-1020) with the correct per-position x index
    (SURVEY.md §B4). ``threads > 1`` stripes diagonal positions across
    workers with private partial-y reduction (rows overlap stripes).
    """

    def __init__(self, tjds, threads: Optional[int] = None):
        lib = _load()
        if lib is None:
            raise RuntimeError(
                "libspmv.so not built (make -C smvp_toolkit_tpu/native)"
            )
        self._lib = lib
        self.shape = tjds.shape
        self.nnz = tjds.nnz
        nd = int(tjds.num_diags)
        self.num_diags = nd
        self.start_pos = np.ascontiguousarray(
            np.asarray(tjds.start_pos)[: nd + 1], dtype=np.int64
        )
        self.row_ind = np.ascontiguousarray(
            np.asarray(tjds.row_ind)[: tjds.nnz], dtype=np.int32
        )
        self.val = np.ascontiguousarray(
            np.asarray(tjds.vals)[: tjds.nnz], dtype=np.float32
        )
        self.perm = np.asarray(tjds.perm)
        if threads is None:
            cpus = os.cpu_count() or 1
            threads = 1 if tjds.nnz < 32768 else cpus
        self.threads = min(threads, 16)

    def __call__(self, x, iterations: int = 1) -> np.ndarray:
        x = np.asarray(x, dtype=np.float32)
        xp = np.ascontiguousarray(x[self.perm])
        y = np.zeros(self.shape[0], dtype=np.float32)
        self._lib.tjds_spmv_f32(
            self.start_pos, self.row_ind, self.val, xp, y,
            self.shape[0], self.num_diags, iterations, self.threads,
        )
        return y


def spmv_tjds_native(tjds, x) -> np.ndarray:
    """One-shot native TJDS SpMV (builds the operator each call)."""
    return NativeTjdsSpMV(tjds)(x)
