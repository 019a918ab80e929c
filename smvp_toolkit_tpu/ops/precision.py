"""Extended-precision SpMV: double-float (float32-pair) arithmetic.

The reference computes SpMV in float64 (main-cli.c:63-66 double arrays).
This path keeps f32 storage and f32 arithmetic and recovers most of the
lost digits by error-free transformation arithmetic: every value is an unevaluated sum ``hi + lo`` of two f32s
(~48 bits of mantissa vs f64's 53). Products use Dekker/Veltkamp
splitting (exact without FMA); the row reduction is a compensated
associative scan followed by the scatter-free row_ptr prefix-difference.
All ops are elementwise/scan work under jit — no f64 dtype.

This is the high-accuracy verification path (and the right tool for
matrices whose row sums cancel, where plain f32 loses all digits).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from smvp_toolkit_tpu.formats.csr import CSRMatrix

__all__ = [
    "two_sum",
    "two_prod",
    "df_split",
    "df_to_f64",
    "spmv_csr_df64",
]

_SPLITTER = jnp.float32(4097.0)  # 2^12 + 1 (Veltkamp split for f32)


def two_sum(a: jax.Array, b: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """Error-free sum: a + b = s + e exactly (Knuth)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def _veltkamp(a: jax.Array) -> Tuple[jax.Array, jax.Array]:
    c = _SPLITTER * a
    hi = c - (c - a)
    return hi, a - hi


def two_prod(a: jax.Array, b: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """Error-free product: a * b = p + e exactly (Dekker, FMA-free)."""
    p = a * b
    ah, al = _veltkamp(a)
    bh, bl = _veltkamp(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def _df_add(a, b):
    """Compensated (hi, lo) + (hi, lo) with renormalization."""
    a_hi, a_lo = a
    b_hi, b_lo = b
    s, e = two_sum(a_hi, b_hi)
    e = e + (a_lo + b_lo)
    return two_sum(s, e)


def df_split(x64) -> Tuple[jax.Array, jax.Array]:
    """Split host f64 values into (hi, lo) f32 pairs."""
    import numpy as np

    x64 = np.asarray(x64, dtype=np.float64)
    hi = x64.astype(np.float32)
    lo = (x64 - hi.astype(np.float64)).astype(np.float32)
    return jnp.asarray(hi), jnp.asarray(lo)


def df_to_f64(hi: jax.Array, lo: jax.Array):
    """Combine a double-float result into host numpy float64."""
    import numpy as np

    return np.asarray(hi, dtype=np.float64) + np.asarray(lo, dtype=np.float64)


@jax.jit
def spmv_csr_df64(
    csr: CSRMatrix,
    x_hi: jax.Array,
    x_lo: jax.Array,
    vals_lo: jax.Array | None = None,
) -> Tuple[jax.Array, jax.Array]:
    """y = A·x in double-float: returns (y_hi, y_lo).

    ``vals_lo`` optionally carries the low words of f64 matrix values
    (from :func:`df_split`); stored f32 values pass ``None``. Products
    are error-free; the reduction is a compensated prefix scan +
    row_ptr difference in df arithmetic (scatter-free, §7 M2 trick).
    """
    xg_hi = x_hi[csr.col_ind]
    xg_lo = x_lo[csr.col_ind]
    p, pe = two_prod(csr.vals, xg_hi)
    p_lo = pe + csr.vals * xg_lo
    if vals_lo is not None:
        p_lo = p_lo + vals_lo * xg_hi

    # Compensated inclusive prefix over the entry stream.
    pref_hi, pref_lo = jax.lax.associative_scan(_df_add, (p, p_lo))
    zero = jnp.zeros((1,), dtype=p.dtype)
    pref_hi = jnp.concatenate([zero, pref_hi])
    pref_lo = jnp.concatenate([zero, pref_lo])

    a_hi = pref_hi[csr.row_ptr[:-1]]
    a_lo = pref_lo[csr.row_ptr[:-1]]
    b_hi = pref_hi[csr.row_ptr[1:]]
    b_lo = pref_lo[csr.row_ptr[1:]]
    return _df_add((b_hi, b_lo), (-a_hi, -a_lo))
