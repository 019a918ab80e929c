"""SpMV that CONSUMES the CISR interleaved-channel schedule.

The reference only ever *encodes* CISR for a hypothetical 16-channel FPGA
consumer (main-cli.c:542-612 scheduling, 690-728 emission) — no code in
the reference computes with it. This module closes that loop: the
(num_groups, slot_count) schedule built by ``formats/cisr.py`` is executed
directly as a data-parallel kernel, channel-per-lane, exactly the
computation the FPGA would perform:

    for each beat g (slot group), each channel s in parallel:
        y[row_of[g, s]] += vals[g, s] * x[col_ind[g, s]]

Device realization: the whole schedule is one (G, S) block — the
x-read is a gather, the per-channel row accumulation is a segment-sum
over ``row_of`` (idle slots carry a sentinel row that lands in a dropped
overflow bucket). Rows are NOT contiguous in the stream (that is the
point of interleaving), so ``indices_are_sorted`` stays False.
"""

from __future__ import annotations

import weakref
from functools import partial
from typing import Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from smvp_toolkit_tpu.formats.cisr import CISRMatrix

__all__ = ["spmv_cisr", "CisrSpMV"]


@partial(jax.jit, static_argnames=("nrows",))
def _cisr_spmv_impl(vals, cols, rows, x, *, nrows):
    prod = vals * x[cols]
    return jax.ops.segment_sum(
        prod.reshape(-1), rows.reshape(-1), num_segments=nrows + 1
    )[:nrows]


class CisrSpMV:
    """Device operator executing a CISR schedule: build once, call many.

    Idle slots (row_of == -1) are retargeted to a sentinel row ``nrows``
    whose accumulator bucket is sliced off; their value is 0 anyway (the
    schedule zero-pads exhausted channels), so the sentinel is belt and
    braces against x-gather garbage at col 0.
    """

    def __init__(self, cisr: CISRMatrix, dtype=None):
        self.shape = cisr.shape
        self.nnz = cisr.nnz
        self.slot_count = cisr.slot_count
        rows = np.asarray(cisr.row_of)
        if dtype is None:
            # Keep complex schedules complex (the segment-sum kernel is
            # dtype-generic); real ones run f32.
            dtype = (
                jnp.complex64
                if np.iscomplexobj(np.asarray(cisr.vals))
                else jnp.float32
            )
        self.vals = jnp.asarray(
            np.where(rows >= 0, cisr.vals, 0.0), dtype=dtype
        )
        self.cols = jnp.asarray(
            np.where(rows >= 0, cisr.col_ind, 0), dtype=jnp.int32
        )
        self.rows = jnp.asarray(
            np.where(rows >= 0, rows, self.shape[0]), dtype=jnp.int32
        )

    def __call__(self, x: jax.Array) -> jax.Array:
        x = jnp.asarray(x)
        if x.dtype != self.vals.dtype:
            x = x.astype(self.vals.dtype)
        return _cisr_spmv_impl(
            self.vals, self.cols, self.rows, x, nrows=self.shape[0]
        )


_CACHE: Dict[int, Tuple[object, CisrSpMV]] = {}


def spmv_cisr(cisr: CISRMatrix, x: jax.Array) -> jax.Array:
    """y = A·x executed from the CISR schedule (operator cached weakly)."""
    key = id(cisr)
    hit = _CACHE.get(key)
    if hit is not None:
        ref, op = hit
        if ref() is cisr:
            return op(x)
        del _CACHE[key]
    op = CisrSpMV(cisr)
    try:
        ref = weakref.ref(cisr, lambda _r, _k=key: _CACHE.pop(_k, None))
    except TypeError:  # pragma: no cover
        ref = lambda m=cisr: m  # noqa: E731
    _CACHE[key] = (ref, op)
    if len(_CACHE) > 64:
        _CACHE.pop(next(iter(_CACHE)))
    return op(x)
