"""Profiler integration: capture XLA device traces around benchmark runs.

The reference's only tracing is wall-clock pairs (SURVEY.md §5); here we
expose ``jax.profiler`` traces (viewable in TensorBoard / Perfetto) as a
context manager and a CLI-facing helper.
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterator, Optional

import jax

__all__ = ["trace", "profile_fn"]


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Capture a device trace into ``log_dir`` (TensorBoard format)."""
    os.makedirs(log_dir, exist_ok=True)
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def profile_fn(fn, *args, log_dir: str, iterations: int = 10):
    """Run ``fn(*args)`` ``iterations`` times under the profiler."""
    result = fn(*args)  # compile outside the trace
    jax.block_until_ready(result)
    with trace(log_dir):
        for _ in range(iterations):
            result = fn(*args)
        jax.block_until_ready(result)
    return result
