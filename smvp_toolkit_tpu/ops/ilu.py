"""Incomplete factorizations (ILU(0) / IC(0)) + data-parallel triangular apply.

New capability beyond the reference toolkit (whose only workload is the
timed ``y = A·x`` loop, main-cli.c:402-420): encode-time incomplete
factorization preconditioners for the solver family in
``models/solvers.py``.

Host/device split of the work:

* **Factorization is host-side, encode-time.** ILU(0)/IC(0) are
  inherently sequential row eliminations (each row consumes finished
  earlier rows) — the wrong shape for a data-parallel device and for
  XLA's static control flow, and they run ONCE per matrix. They execute
  in numpy float64 on the host, like the native counting-sort
  encoders.
* **Application is device-side, fixed-shape.** The classic forward/back
  substitution is also sequential, and level-scheduled solves degrade to
  ``nrows`` steps on banded matrices (a tridiagonal matrix has one level
  per row). Instead the apply uses a FIXED-SWEEP truncated-Neumann
  (Jacobi) solve: for a triangular ``T = D + N`` (``N`` strictly
  triangular, hence nilpotent),

      z_s = sum_{k<s} (-D^-1 N)^k D^-1 r

  computed as ``s`` SpMV + elementwise-multiply sweeps — static trip
  count, no data-dependent control flow, every FLOP on the SpMV path
  (injectable: XLA, cuSPARSE, or sharded). The series is
  EXACT once ``s`` exceeds the nilpotency index, and a valid
  preconditioner at any ``s``.

  For IC(0) the composite apply with EQUAL sweep counts is exactly
  ``P_Lᵀ·P_L`` (the transposed-solve polynomial is the transpose of the
  forward one), i.e. symmetric positive definite for EVERY sweep count —
  so the inexact apply is rigorously CG-safe, not just heuristically so.
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Callable, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from smvp_toolkit_tpu.formats.coo import COOMatrix
from smvp_toolkit_tpu.formats.csr import CSRMatrix, csr_encode
from smvp_toolkit_tpu.ops.spmv_xla import spmv_csr

__all__ = [
    "ILU0Factors",
    "IC0Factors",
    "ilu0",
    "ic0",
    "split_triangular",
    "trisolve_neumann",
]

_PAD = 128  # lane-width padding for the factor CSR planes


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ILU0Factors:
    """A ≈ (I + L)·(D_u + U): unit lower + upper incomplete factors.

    ``l_strict``/``u_strict`` hold the strictly-triangular parts as
    ordinary :class:`CSRMatrix` pytrees (any SpMV kernel applies);
    ``u_diag`` is U's diagonal. Pattern identity of ILU(0): the product
    matches A exactly on A's sparsity pattern.
    """

    l_strict: CSRMatrix
    u_strict: CSRMatrix
    u_diag: jax.Array  # f32[nrows]

    @property
    def shape(self) -> Tuple[int, int]:
        return self.l_strict.shape


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class IC0Factors:
    """A ≈ L·Lᵀ (SPD): strict lower triangle + diagonal, plus Lᵀ.

    ``strict_t`` (the strictly-upper transpose) is materialized at
    factorization time so the backward solve is a plain CSR SpMV too —
    no device-side transpose ever runs.
    """

    strict: CSRMatrix  # strictly lower part of L
    strict_t: CSRMatrix  # its transpose (strictly upper)
    diag: jax.Array  # f32[nrows], diag(L) > 0

    @property
    def shape(self) -> Tuple[int, int]:
        return self.strict.shape


def _csr_host(csr: CSRMatrix):
    """(row_ptr, col_ind, vals) as trimmed host f64 arrays."""
    rp = np.asarray(csr.row_ptr, dtype=np.int64)
    true_nnz = int(rp[csr.shape[0]])
    ci = np.asarray(csr.col_ind, dtype=np.int64)[:true_nnz]
    v = np.asarray(csr.vals)[:true_nnz]
    if np.iscomplexobj(v):
        raise ValueError(
            "incomplete factorizations support real matrices only"
        )
    return rp, ci, v.astype(np.float64)


def _tri_csr(
    rows: np.ndarray, cols: np.ndarray, vals: np.ndarray, n: int, dtype
) -> CSRMatrix:
    """Encode host triplets of a (strictly) triangular part as CSR."""
    coo = COOMatrix.from_numpy(
        np.asarray(rows, np.int32),
        np.asarray(cols, np.int32),
        np.asarray(vals, np.float64),
        shape=(n, n),
        dtype=dtype,
        pad_to=_PAD,
    )
    return csr_encode(coo)


_F32_SAFE = 1e30  # factor-entry magnitude cap (f32 storage must not overflow)

_ILU_LIB = None
_ILU_LIB_FAILED = False


def _ilu_lib():
    """ctypes handle to native/libilu.so (None if unavailable/disabled)."""
    global _ILU_LIB, _ILU_LIB_FAILED
    import ctypes
    import os

    if os.environ.get("SMVP_NATIVE_ILU") == "0":
        return None
    if _ILU_LIB is not None:
        return _ILU_LIB
    if _ILU_LIB_FAILED:
        return None
    here = os.path.dirname(os.path.abspath(__file__))
    path = os.path.abspath(os.path.join(here, "..", "native", "libilu.so"))
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        _ILU_LIB_FAILED = True
        return None
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    ll, dbl = ctypes.c_longlong, ctypes.c_double
    lib.ilu0_pass.restype = ll
    lib.ilu0_pass.argtypes = [i64p, i64p, ll, dbl, dbl, f64p, f64p]
    lib.ic0_pass.restype = ll
    lib.ic0_pass.argtypes = [i64p, i64p, f64p, ll, dbl, dbl, f64p, i64p,
                             f64p]
    _ILU_LIB = lib
    return lib


def _native_ilu0_pass():
    """Native twin of :func:`_ilu0_pass` (bit-identical), or None."""
    lib = _ilu_lib()
    if lib is None:
        return None

    def pass_fn(rp, ci, v, n, shift, floor):
        fac = np.ascontiguousarray(v, dtype=np.float64).copy()
        u_diag = np.empty(n, np.float64)
        fixed = lib.ilu0_pass(
            np.ascontiguousarray(rp, np.int64),
            np.ascontiguousarray(ci, np.int64),
            n, shift, floor, fac, u_diag,
        )
        return fac, u_diag, int(fixed)

    return pass_fn


def _native_ic0_pass():
    """Native twin of :func:`_ic0_pass` (bit-identical), or None."""
    lib = _ilu_lib()
    if lib is None:
        return None

    def pass_fn(rp, ci, v, n, shift, piv_floor):
        v64 = np.ascontiguousarray(v, dtype=np.float64)
        fac = v64.copy()
        lo_cut = np.empty(n, np.int64)
        diag = np.empty(n, np.float64)
        breakdowns = lib.ic0_pass(
            np.ascontiguousarray(rp, np.int64),
            np.ascontiguousarray(ci, np.int64),
            v64, n, shift, piv_floor, fac, lo_cut, diag,
        )
        return fac, lo_cut, diag, int(breakdowns)

    return pass_fn


def _shift_ladder(scale: float):
    """Manteuffel shift candidates: 0, then scale·1e-3·10^k."""
    base = max(scale, 1e-30) * 1e-3
    return [0.0] + [base * 10.0**k for k in range(8)]


def _factors_usable(arrays, repaired: int, n: int) -> bool:
    """Accept a factorization pass: finite, f32-safe, few repaired pivots.

    A handful of repaired pivots is a local wart; a cascade (>1% of
    rows) means the elimination is feeding on garbage and the whole
    factor is distorted — retry with a diagonal shift instead.
    """
    if repaired > max(1, n // 100):
        return False
    return all(
        a.size == 0 or (np.isfinite(a).all() and np.abs(a).max() < _F32_SAFE)
        for a in arrays
    )


def _ilu0_pass(rp, ci, v, n: int, shift: float, floor: float):
    """One IKJ elimination sweep of A + shift·I, in place on A's pattern.

    Returns ``(fac, u_diag, fixed_pivots)``: ``fac`` holds the factor
    value at every CSR slot (cols < row → L, cols > row → strict U;
    the diagonal slot keeps its pre-shift value — the canonical pivot
    lives in ``u_diag``). The native fast path (``native/ilu.cpp``)
    mirrors this loop operation-for-operation, so both produce
    bit-identical arrays (tests/test_ilu.py differential test).
    """
    fac = v.copy()
    u_diag = np.empty(n, np.float64)
    # u_start[k]: first strict-U slot of finished row k.
    u_start = np.empty(n, np.int64)
    fixed_pivots = 0

    for i in range(n):
        lo, hi = int(rp[i]), int(rp[i + 1])
        cols_i = ci[lo:hi]  # ascending (csr_encode sorts by (row, col))
        pos = {int(c): t for t, c in enumerate(cols_i)}
        for t in range(cols_i.size):
            k = int(cols_i[t])
            if k >= i:
                break
            w = fac[lo + t] / u_diag[k]
            fac[lo + t] = w
            for s in range(int(u_start[k]), int(rp[k + 1])):
                tj = pos.get(int(ci[s]))
                if tj is not None:
                    fac[lo + tj] -= w * fac[s]
        split = int(np.searchsorted(cols_i, i))
        if split < cols_i.size and cols_i[split] == i:
            piv = fac[lo + split] + shift
            u_start[i] = lo + split + 1
        else:  # structurally missing diagonal
            piv = shift
            u_start[i] = lo + split
        if abs(piv) < floor:
            piv = floor if piv >= 0 else -floor
            fixed_pivots += 1
        u_diag[i] = piv
    return fac, u_diag, fixed_pivots


def ilu0(csr: CSRMatrix) -> ILU0Factors:
    """ILU(0): incomplete LU with zero fill-in (pattern of A).

    Host-side IKJ row elimination in float64 (sequential by nature — see
    module docstring for why this is not device work). A handful of
    zero/tiny pivots is repaired by a scale-relative static floor; if
    pivot repair cascades (>1% of rows) or factor entries blow past the
    f32-safe range — both symptoms of a structurally degenerate input —
    the factorization restarts on ``A + αI`` with an escalating
    Manteuffel shift and warns with the shift it settled on. The
    shifted factors precondition the ORIGINAL system (a preconditioner
    only needs to be a fixed nonsingular operator near A⁻¹).

    Cost is O(sum over rows of row_nnz · avg U-row length) — encode-time
    host work, like the native encoders.
    """
    n, m = csr.shape
    if n != m:
        raise ValueError(f"ilu0 needs a square matrix, got {csr.shape}")
    rp, ci, v = _csr_host(csr)

    scale = float(np.max(np.abs(v))) if v.size else 1.0
    floor = max(scale, 1e-30) * 1e-4
    pass_fn = _native_ilu0_pass() or _ilu0_pass
    with np.errstate(over="ignore", invalid="ignore"):
        for shift in _shift_ladder(scale):
            fac, u_diag, fixed = pass_fn(rp, ci, v, n, shift, floor)
            if _factors_usable((fac, u_diag), fixed, n):
                break
        else:
            raise ValueError(
                "ilu0: factorization kept producing unusable factors "
                "even at the largest diagonal shift — the matrix is "
                "numerically singular at working precision"
            )
    if shift or fixed:
        what = []
        if shift:
            what.append(f"diagonal shift {shift:g}")
        if fixed:
            what.append(f"{fixed} static-floored pivot(s)")
        warnings.warn(
            "ilu0: input is far from regular; completed with "
            + " and ".join(what)
            + " — the preconditioner stays usable but is weakened",
            stacklevel=2,
        )
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(rp[: n + 1]))
    low = ci < rows
    up = ci > rows
    dtype = csr.vals.dtype
    return ILU0Factors(
        l_strict=_tri_csr(rows[low], ci[low], fac[low], n, dtype),
        u_strict=_tri_csr(rows[up], ci[up], fac[up], n, dtype),
        u_diag=jnp.asarray(u_diag, dtype),
    )


def _ic0_pass(rp, ci, v, n: int, shift: float, piv_floor: float):
    """One IC(0) sweep of A + shift·I, in place on the lower pattern.

    Returns ``(fac, lo_cut, diag, breakdowns)``: ``fac[rp[i]:lo_cut[i]]``
    are row i's strict-lower L values (slots at/above the diagonal are
    left untouched), ``diag`` is diag(L). Mirrored
    operation-for-operation by ``native/ilu.cpp`` (bit-identical).
    """
    fac = v.copy()
    lo_cut = np.empty(n, np.int64)  # first non-lower slot per row
    diag = np.empty(n, np.float64)
    breakdowns = 0

    for i in range(n):
        lo, hi = int(rp[i]), int(rp[i + 1])
        cols_i = ci[lo:hi]
        cut = int(np.searchsorted(cols_i, i))
        lo_cut[i] = lo + cut
        a_ii = (
            float(v[lo + cut])
            if cut < cols_i.size and cols_i[cut] == i
            else 0.0
        ) + shift
        my_pos = {int(c): t for t, c in enumerate(cols_i[:cut])}
        for t in range(cut):
            k = int(cols_i[t])
            # dot over pattern(i) ∩ pattern(k) restricted to cols < k
            s = 0.0
            for u in range(int(rp[k]), int(lo_cut[k])):
                tu = my_pos.get(int(ci[u]))
                if tu is not None:
                    s += fac[lo + tu] * fac[u]
            fac[lo + t] = (fac[lo + t] - s) / diag[k]
        acc = 0.0
        for t in range(cut):
            acc += fac[lo + t] * fac[lo + t]
        pivot2 = a_ii - acc
        if pivot2 < piv_floor:
            breakdowns += pivot2 <= 0.0
            pivot2 = max(abs(a_ii), piv_floor)
        diag[i] = math.sqrt(pivot2)
    return fac, lo_cut, diag, breakdowns


def ic0(csr: CSRMatrix) -> IC0Factors:
    """IC(0): incomplete Cholesky A ≈ L·Lᵀ on A's lower-triangle pattern.

    For symmetric positive definite systems — half the storage and
    sweeps of :func:`ilu0`, and the fixed-sweep apply is exactly
    symmetric PD (module docstring). An isolated non-positive pivot
    (possible for SPD matrices far from diagonal dominance) is repaired
    with a scale-relative floor; a breakdown CASCADE (>1% of rows, or
    factor entries past the f32-safe range — the signature of an
    indefinite input) restarts the factorization on ``A + αI`` with an
    escalating Manteuffel shift, warning with the shift used. The
    result is always a finite PD factor usable as a preconditioner.

    Only the lower triangle of ``csr`` is read; the strict upper part is
    ignored, so symmetric-stored or fully-expanded inputs factor
    identically.
    """
    n, m = csr.shape
    if n != m:
        raise ValueError(f"ic0 needs a square matrix, got {csr.shape}")
    rp, ci, v = _csr_host(csr)

    # Breakdown repair floor: relative to the matrix scale, so a
    # zero/negative pivot yields an O(sqrt(scale)) diagonal — a benign
    # near-identity row in the preconditioner — instead of the 1/sqrt(eps)
    # blow-up an absolute epsilon floor would produce.
    scale = float(np.max(np.abs(v))) if v.size else 1.0
    piv_floor = max(scale, 1e-30) * 1e-3

    pass_fn = _native_ic0_pass() or _ic0_pass
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(rp[: n + 1]))
    slot = np.arange(ci.size, dtype=np.int64)
    with np.errstate(over="ignore", invalid="ignore"):
        for shift in _shift_ladder(scale):
            fac, lo_cut, diag, breakdowns = pass_fn(
                rp, ci, v, n, shift, piv_floor
            )
            low = slot < lo_cut[rows]
            if _factors_usable((fac[low], diag), breakdowns, n):
                break
        else:
            raise ValueError(
                "ic0: factorization kept breaking down even at the "
                "largest diagonal shift — the matrix is nowhere near "
                "SPD; use ilu0 + bicgstab/gmres instead"
            )
    if shift or breakdowns:
        what = []
        if shift:
            what.append(f"diagonal shift {shift:g}")
        if breakdowns:
            what.append(f"{breakdowns} locally repaired pivot(s)")
        warnings.warn(
            "ic0: input is SPD-marginal; completed with "
            + " and ".join(what)
            + " — the factor remains PD and usable",
            stacklevel=2,
        )
    l_rows, l_cols, l_vals = rows[low], ci[low], fac[low]
    dtype = csr.vals.dtype
    return IC0Factors(
        strict=_tri_csr(l_rows, l_cols, l_vals, n, dtype),
        strict_t=_tri_csr(l_cols, l_rows, l_vals, n, dtype),
        diag=jnp.asarray(diag, dtype),
    )


def split_triangular(
    csr: CSRMatrix,
) -> Tuple[CSRMatrix, jax.Array, CSRMatrix]:
    """Host-side split of A into (strict lower, diagonal, strict upper).

    The zero-setup-cost feed for the SSOR preconditioner
    (:func:`~smvp_toolkit_tpu.models.solvers.ssor_preconditioner`):
    unlike :func:`ilu0`/:func:`ic0` there is no elimination at all —
    the parts ARE submatrices of A, returned as ordinary
    :class:`CSRMatrix` pytrees plus a dense diagonal (structurally
    missing diagonal entries read as 0).
    """
    n, m = csr.shape
    if n != m:
        raise ValueError(
            f"split_triangular needs a square matrix, got {csr.shape}"
        )
    rp, ci, v = _csr_host(csr)
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(rp[: n + 1]))
    low = ci < rows
    up = ci > rows
    dia = ci == rows
    d = np.zeros(n, np.float64)
    d[rows[dia]] = v[dia]
    dtype = csr.vals.dtype
    return (
        _tri_csr(rows[low], ci[low], v[low], n, dtype),
        jnp.asarray(d, dtype),
        _tri_csr(rows[up], ci[up], v[up], n, dtype),
    )


def trisolve_neumann(
    strict: CSRMatrix,
    diag: jax.Array,
    r: jax.Array,
    sweeps: int = 4,
    spmv: Callable = spmv_csr,
) -> jax.Array:
    """Approximate ``(D + N)⁻¹ r`` by ``sweeps`` Jacobi iterations.

    ``N`` (``strict``) must be strictly triangular, making the iteration
    matrix nilpotent: the sweep-``s`` result is the truncated Neumann
    series ``sum_{k<s} (-D⁻¹N)^k D⁻¹ r``, exact for ``s`` past the
    nilpotency index and a nonsingular linear map for every ``s``.
    Pass ``diag=None`` for a unit-diagonal factor. The static Python
    loop unrolls under ``jit`` into ``sweeps`` fused SpMV stages.
    """
    if diag is None:
        z = r
        for _ in range(sweeps - 1):
            z = r - spmv(strict, z)
        return z
    inv_d = 1.0 / diag
    z = inv_d * r
    for _ in range(sweeps - 1):
        z = inv_d * (r - spmv(strict, z))
    return z
