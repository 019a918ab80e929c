"""Host fast path for COO→CSR / COO→TJDS encode (native counting sorts).

The XLA encoders (``formats/csr.py``, ``formats/tjds.py``) are the right
shape for device execution, but on the host path (CLI encode, bench
setup, shard planning) a large matrix pays general comparison sorts
plus one extra compiled program per shape. Every
encode sort key is a bounded integer, so ``native/encode.cpp`` replaces
them with stable counting sorts: O(nnz + nrows + ncols), bit-identical
output order (tests/test_native_encode.py proves equality array-by-array
against the XLA encoders).

This module only computes permutations and integer side-products; the
format modules apply the permutation to the value array (any dtype) and
assemble the dataclasses.

Dispatch rule (``use_native``): the fast path engages when the triplet
arrays are host-reachable without a device pull — numpy arrays or
CPU-backed jax arrays. Off-CPU arrays fall back to the XLA encoder
unless ``SMVP_NATIVE_ENCODE=1`` forces the pull; ``SMVP_NATIVE_ENCODE=0``
disables the native path entirely. Traced values always use XLA.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional, Tuple

import numpy as np

__all__ = ["use_native", "host_triplets", "csr_order", "tjds_order"]

_LIB = None
_LIB_FAILED = False
_LOCK = threading.Lock()


def _lib():
    """ctypes handle to the native encoder (None if unavailable)."""
    global _LIB, _LIB_FAILED
    with _LOCK:
        if _LIB is not None:
            return _LIB
        if _LIB_FAILED or os.environ.get("SMVP_NATIVE_ENCODE") == "0":
            return None
        here = os.path.dirname(os.path.abspath(__file__))
        path = os.path.abspath(
            os.path.join(here, "..", "native", "libencode.so")
        )
        if not os.path.exists(path):
            _LIB_FAILED = True
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:  # pragma: no cover
            _LIB_FAILED = True
            return None
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        ll = ctypes.c_longlong
        lib.csr_encode_order.restype = None
        lib.csr_encode_order.argtypes = [i32p, i32p, ll, ll, ll, ll, i64p, i32p]
        lib.tjds_encode_order.restype = ll
        lib.tjds_encode_order.argtypes = [
            i32p, i32p, ll, ll, ll, ll, ll, i64p, i32p, i32p, i32p,
        ]
        _LIB = lib
        return lib


def _is_cpu_backed(x) -> bool:
    if isinstance(x, np.ndarray):
        return True
    try:
        return all(d.platform == "cpu" for d in x.devices())
    except Exception:  # pragma: no cover — odd array types
        return False


def use_native(coo) -> bool:
    """True when the native encoder should handle this COO."""
    import jax

    if os.environ.get("SMVP_NATIVE_ENCODE") == "0" or _lib() is None:
        return False
    if any(
        isinstance(a, jax.core.Tracer) for a in (coo.rows, coo.cols, coo.vals)
    ):
        return False
    if os.environ.get("SMVP_NATIVE_ENCODE") == "1":
        return True
    return all(_is_cpu_backed(a) for a in (coo.rows, coo.cols, coo.vals))


def host_triplets(coo) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pull (rows, cols, vals) to host with encode sentinels forced.

    Matches the XLA encoders' defensive masking: padding slots carry
    ``row == nrows``, ``col == 0``, ``val == 0`` regardless of how the
    COO was constructed.
    """
    nnz = coo.nnz
    r = np.ascontiguousarray(np.asarray(coo.rows, dtype=np.int32))
    c = np.ascontiguousarray(np.asarray(coo.cols, dtype=np.int32))
    v = np.asarray(coo.vals)
    if nnz < r.shape[0]:
        r = r.copy()
        c = c.copy()
        v = v.copy()
        r[nnz:] = coo.shape[0]
        c[nnz:] = 0
        v[nnz:] = 0
    return r, c, v


def csr_order(
    r: np.ndarray, c: np.ndarray, nnz: int, nrows: int, ncols: int
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Stable (row, col) sort order + row_ptr. None if lib unavailable."""
    lib = _lib()
    if lib is None:
        return None
    npad = int(r.shape[0])
    order = np.empty(npad, dtype=np.int64)
    row_ptr = np.empty(nrows + 1, dtype=np.int32)
    lib.csr_encode_order(r, c, nnz, npad, nrows, ncols, order, row_ptr)
    return order, row_ptr


def tjds_order(
    r: np.ndarray,
    c: np.ndarray,
    nnz: int,
    nrows: int,
    ncols: int,
    diag_bound: int,
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, int]]:
    """TJDS pack order, offsets, perm, start_pos, num_diags (or None)."""
    lib = _lib()
    if lib is None:
        return None
    npad = int(r.shape[0])
    order = np.empty(npad, dtype=np.int64)
    offsets = np.empty(npad, dtype=np.int32)
    perm = np.empty(max(ncols, 1), dtype=np.int32)
    start_pos = np.empty(diag_bound + 1, dtype=np.int32)
    num_diags = lib.tjds_encode_order(
        r, c, nnz, npad, nrows, ncols, diag_bound, order, offsets, perm,
        start_pos,
    )
    return order, offsets, perm[:ncols], start_pos, int(num_diags)
