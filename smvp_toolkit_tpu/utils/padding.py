"""Static-shape padding/alignment helpers (stable shapes, fewer compiles)."""

from __future__ import annotations

import jax.numpy as jnp

__all__ = ["round_up", "pad_to"]


def round_up(x: int, multiple: int) -> int:
    """Smallest multiple of ``multiple`` that is >= x (and >= multiple)."""
    if multiple <= 1:
        return max(int(x), 1)
    return max(-(-int(x) // multiple) * multiple, multiple)


def pad_to(arr, total: int, fill=0):
    """Pad a 1-D array to ``total`` elements with ``fill`` (no-op if long)."""
    cur = arr.shape[0]
    if cur >= total:
        return arr
    return jnp.concatenate(
        [arr, jnp.full((total - cur,), fill, dtype=arr.dtype)]
    )
