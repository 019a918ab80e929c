"""CISR (Compressed Interleaved Sparse Row) codec + Vivado ``.coe`` emitter.

Capability parity with the reference's ``smvp_cisr_coegen``
(main-cli.c:473-729): rows are scheduled round-robin onto ``slot_count``
parallel channels (the FPGA consumer's lanes); each slot streams its row's
nonzeros one per "slot group" (a clock beat across all channels), picking up
the next unassigned row when its row is exhausted; exhausted slots emit
zero padding. The packed ``.coe`` memory image interleaves value words with
row-length words (packing spec per the reference comment main-cli.c:673-688).

Re-design notes (this is a serialization format, not device compute —
SURVEY.md §7 M7):

* Host-side vectorized numpy scheduler (no C loops over slot groups).
* Empty rows are handled correctly: they consume a row-length record of 0
  and no slot beats (the reference mis-emits the next row's first entry for
  empty rows; all its samples have none).
* Packing masks fields to their widths (value 12 bits, col 12 bits, slot
  8 bits) instead of relying on C shift overflow (SURVEY.md §B8); the
  truncation of double values into 12 bits is inherent to the reference
  format and documented here.
* Opt-in, parameterized; a decoder reconstructs (row, col, val-as-packed)
  for round-trip testing. The scheduler tables also drive the
  channel-interleaved SpMV of ``ops/spmv_cisr.py``.
"""

from __future__ import annotations

import dataclasses
import io as _io
from typing import List, Optional, Tuple, Union

import numpy as np

from smvp_toolkit_tpu.formats.coo import COOMatrix
from smvp_toolkit_tpu.formats.csr import CSRMatrix

__all__ = ["CISRMatrix", "cisr_encode", "cisr_decode", "write_coe"]

_START_WORD = 0xAAAAAAAA
_END_WORD = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class CISRMatrix:
    """CISR interleaved-channel schedule (host-side numpy arrays).

    ``vals``/``col_ind``/``slot_map`` have shape (num_groups, slot_count):
    element [g, s] is what channel ``s`` consumes at beat ``g`` (0/0 padding
    when idle). ``row_of`` carries the matrix row feeding [g, s] (-1 when
    idle) — derived scratch for decode/SpMV, not part of the wire format.
    ``row_lengths`` is the per-row nnz stream in row-pickup order.
    """

    vals: np.ndarray  # float64[num_groups, slot_count]
    col_ind: np.ndarray  # int32[num_groups, slot_count]
    row_of: np.ndarray  # int32[num_groups, slot_count], -1 = idle
    row_lengths: np.ndarray  # int32[nrows]
    slot_count: int
    shape: Tuple[int, int]
    nnz: int

    @property
    def num_groups(self) -> int:
        return int(self.vals.shape[0])

    def __repr__(self) -> str:
        return (
            f"CISRMatrix(shape={self.shape}, nnz={self.nnz}, "
            f"slots={self.slot_count}, groups={self.num_groups})"
        )


def _csr_host(matrix: Union[COOMatrix, CSRMatrix]):
    """Row-major CSR arrays on host from either a COO or CSR input."""
    if isinstance(matrix, CSRMatrix):
        row_ptr = np.asarray(matrix.row_ptr)
        col = np.asarray(matrix.col_ind)[: matrix.nnz]
        val = np.asarray(matrix.vals)[: matrix.nnz]
        return row_ptr, col, val, matrix.shape, matrix.nnz
    r, c, v = matrix.to_numpy()
    order = np.lexsort((c, r))
    r, c, v = r[order], c[order], v[order]
    row_ptr = np.searchsorted(r, np.arange(matrix.shape[0] + 1)).astype(np.int64)
    return row_ptr, c, v, matrix.shape, matrix.nnz


def _native_lib():
    """Load the C++ scheduler library (None if not built)."""
    global _CISR_LIB
    if _CISR_LIB is not False and _CISR_LIB is not None:
        return _CISR_LIB
    if _CISR_LIB is False:
        return None
    import ctypes
    import os

    here = os.path.dirname(os.path.abspath(__file__))
    path = os.path.join(here, "..", "native", "libcisr.so")
    if not os.path.exists(path):
        _CISR_LIB = False
        return None
    try:
        lib = ctypes.CDLL(os.path.abspath(path))
    except OSError:  # pragma: no cover
        _CISR_LIB = False
        return None
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    lib.cisr_num_groups.restype = ctypes.c_longlong
    lib.cisr_num_groups.argtypes = [i64p, ctypes.c_longlong, ctypes.c_int]
    lib.cisr_schedule.restype = ctypes.c_int
    lib.cisr_schedule.argtypes = [
        i64p, i32p, f64p, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_longlong, f64p, i32p, i32p, i32p,
    ]
    _CISR_LIB = lib
    return lib


_CISR_LIB = None


def _cisr_encode_native(row_ptr, col, val, shape, nnz, slot_count):
    """C++ scheduler fast path (semantics identical to the Python loop)."""
    lib = _native_lib()
    if lib is None:
        return None
    nrows = shape[0]
    rp = np.ascontiguousarray(row_ptr, dtype=np.int64)
    cc = np.ascontiguousarray(col, dtype=np.int32)
    vv = np.ascontiguousarray(val, dtype=np.float64)
    beats = int(lib.cisr_num_groups(rp, nrows, slot_count))
    if beats < 0:
        return None
    out_val = np.zeros((beats, slot_count), dtype=np.float64)
    out_col = np.zeros((beats, slot_count), dtype=np.int32)
    out_row = np.full((beats, slot_count), -1, dtype=np.int32)
    row_lengths = np.zeros(max(nrows, 1), dtype=np.int32)
    rc = lib.cisr_schedule(
        rp, cc, vv, nrows, slot_count, beats,
        out_val.reshape(-1), out_col.reshape(-1), out_row.reshape(-1),
        row_lengths,
    )
    if rc != 0:
        return None
    return CISRMatrix(
        vals=out_val,
        col_ind=out_col,
        row_of=out_row,
        row_lengths=row_lengths[:nrows],
        slot_count=slot_count,
        shape=shape,
        nnz=nnz,
    )


def cisr_encode(
    matrix: Union[COOMatrix, CSRMatrix],
    slot_count: int = 16,
    *,
    use_native: bool = True,
) -> CISRMatrix:
    """Schedule CSR rows onto ``slot_count`` interleaved channels.

    Greedy row pickup in row order, matching the reference scheduler
    (main-cli.c:542-612): slot s takes the next unassigned row whenever its
    current row is exhausted; beats where a slot has no work emit (0, 0).

    The per-beat loop is sequential by nature; with ``use_native=True``
    the C++ scheduler (native/cisr.cpp) runs it ~100x faster than the
    Python fallback below (identical semantics, tested equal).
    """
    if slot_count < 1:
        raise ValueError("slot_count must be >= 1")
    row_ptr, col, val, shape, nnz = _csr_host(matrix)
    # The C++ scheduler is f64-only; complex schedules use the Python
    # path (which preserves the value dtype).
    if use_native and not np.iscomplexobj(np.asarray(val)):
        result = _cisr_encode_native(row_ptr, col, val, shape, nnz, slot_count)
        if result is not None:
            return result
    nrows = shape[0]
    row_len = np.diff(row_ptr).astype(np.int64)

    # Assign rows to slots by greedy pickup, tracking per-slot cursors.
    vals_out: List[List[float]] = [[] for _ in range(slot_count)]
    cols_out: List[List[int]] = [[] for _ in range(slot_count)]
    rows_out: List[List[int]] = [[] for _ in range(slot_count)]
    row_lengths: List[int] = []

    next_row = 0
    # remaining[s] = entries left in slot s's current row
    cursor = np.zeros(slot_count, dtype=np.int64)  # nnz index per slot
    remaining = np.zeros(slot_count, dtype=np.int64)

    def _pickup(s: int) -> bool:
        """Give slot s its next non-empty row; record empty rows' lengths."""
        nonlocal next_row
        while next_row < nrows:
            r = next_row
            next_row += 1
            row_lengths.append(int(row_len[r]))
            if row_len[r] > 0:
                cursor[s] = row_ptr[r]
                remaining[s] = row_len[r]
                # Tag entries with their row for decode.
                rows_out[s].extend([r] * int(row_len[r]))
                return True
        return False

    active = np.zeros(slot_count, dtype=bool)
    for s in range(slot_count):
        active[s] = _pickup(s)

    while active.any():
        for s in range(slot_count):
            if active[s]:
                j = cursor[s]
                vals_out[s].append(complex(val[j]) if np.iscomplexobj(val) else float(val[j]))
                cols_out[s].append(int(col[j]))
                cursor[s] += 1
                remaining[s] -= 1
                if remaining[s] == 0:
                    active[s] = _pickup(s)
            else:
                vals_out[s].append(0.0)
                cols_out[s].append(0)
                rows_out[s].append(-1)

    num_groups = max((len(v) for v in vals_out), default=0)
    val_dtype = (
        np.complex128 if np.iscomplexobj(np.asarray(val)) else np.float64
    )
    vals_arr = np.zeros((num_groups, slot_count), dtype=val_dtype)
    cols_arr = np.zeros((num_groups, slot_count), dtype=np.int32)
    rowof_arr = np.full((num_groups, slot_count), -1, dtype=np.int32)
    for s in range(slot_count):
        n = len(vals_out[s])
        vals_arr[:n, s] = vals_out[s]
        cols_arr[:n, s] = cols_out[s]
        rowof_arr[: len(rows_out[s]), s] = rows_out[s]

    # Rows never picked up (trailing empty rows after the last pickup).
    while len(row_lengths) < nrows:
        row_lengths.append(0)

    return CISRMatrix(
        vals=vals_arr,
        col_ind=cols_arr,
        row_of=rowof_arr,
        row_lengths=np.asarray(row_lengths, dtype=np.int32),
        slot_count=slot_count,
        shape=shape,
        nnz=nnz,
    )


def cisr_decode(cisr: CISRMatrix) -> COOMatrix:
    """Reconstruct COO triplets from the CISR schedule (round-trip check)."""
    mask = cisr.row_of >= 0
    r = cisr.row_of[mask].astype(np.int32)
    c = cisr.col_ind[mask].astype(np.int32)
    v = cisr.vals[mask]
    order = np.lexsort((c, r))
    return COOMatrix.from_numpy(
        r[order], c[order], v[order], shape=cisr.shape, dtype=v.dtype
    )


# ---------------------------------------------------------------------------
# .coe emission (packing spec per reference comment main-cli.c:673-688)
# ---------------------------------------------------------------------------


def pack_value_word(val: float, col: int, slot: int) -> int:
    """Control code 1 payload: VVV III NN (12b value, 12b col, 8b slot).

    The reference packs ``(int)val << 20 | col << 8 | slot``
    (main-cli.c:703); we mask each field to its documented width instead of
    relying on shift overflow (SURVEY.md §B8).
    """
    return ((int(val) & 0xFFF) << 20) | ((int(col) & 0xFFF) << 8) | (int(slot) & 0xFF)


def pack_rowlen_word(len_a: int, len_b: Optional[int]) -> int:
    """Control code 2 payload: VAAA VBBB (valid bit + 12b length, twice)."""
    word = (1 << 28) | ((int(len_a) & 0xFFF) << 16)
    if len_b is not None:
        word |= (1 << 12) | (int(len_b) & 0xFFF)
    return word


def write_coe(
    cisr: CISRMatrix,
    dest: Union[str, "_io.TextIOBase", None] = None,
) -> str:
    """Emit the Vivado single-port-BRAM ``.coe`` image for a CISR schedule.

    Stream layout matches the reference emitter (main-cli.c:690-728): a
    start word, then per beat×slot one value word, interleaved with a
    row-length word (two lengths per word) while lengths remain, then an
    end word. Returns the text; optionally writes to ``dest``.
    """
    if np.iscomplexobj(cisr.vals):
        raise ValueError(
            "the COE packed format is real-valued (12-bit integer value "
            "field, main-cli.c:673-688); cannot pack a complex matrix"
        )
    lines = [
        ";*********************************************",
        ";* CISR COE File for Vivado Single-Port BRAM *",
        ";*********************************************",
        "",
        f";Generated with a slot/channel count of: {cisr.slot_count}",
        "",
        "memory_initialization_radix=16;",
        "memory_initialization_vector=",
        f"00{_START_WORD:08x},",
    ]
    flat_vals = cisr.vals.reshape(-1)
    flat_cols = cisr.col_ind.reshape(-1)
    slots = np.tile(np.arange(cisr.slot_count), cisr.num_groups)
    nrows = cisr.shape[0]
    rl = cisr.row_lengths
    rl_iter = 0
    for i in range(flat_vals.shape[0]):
        lines.append(f"01{pack_value_word(flat_vals[i], flat_cols[i], slots[i]):08x},")
        if rl_iter < nrows:
            a = rl[rl_iter]
            rl_iter += 1
            b = None
            if rl_iter < nrows:
                b = rl[rl_iter]
                rl_iter += 1
            lines.append(f"02{pack_rowlen_word(a, b):08x},")
    # Flush row-length records beyond 2x the value-word count (possible
    # when many rows are empty: correct empty-row handling produces fewer
    # beats than rows, which the reference never hits because its
    # scheduler assumes every row yields a value word).
    while rl_iter < nrows:
        a = rl[rl_iter]
        rl_iter += 1
        b = None
        if rl_iter < nrows:
            b = rl[rl_iter]
            rl_iter += 1
        lines.append(f"02{pack_rowlen_word(a, b):08x},")
    lines.append(f"03{_END_WORD:08x};")
    lines.append("")
    text = "\n".join(lines)
    if dest is None:
        return text
    if hasattr(dest, "write"):
        dest.write(text)
    else:
        with open(dest, "w") as f:
            f.write(text)
    return text
