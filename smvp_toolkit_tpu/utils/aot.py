"""Ahead-of-time export of compiled sparse programs (the serving path).

Production deployments encode a matrix once and then serve ``y = A·x``
(or whole solver loops) many times — often from processes that should
pay neither Python tracing nor XLA compile cost, and that need no
access to the encoder/planner code at all. ``jax.export`` serializes
the lowered StableHLO module (encoded-matrix planes baked in as module
constants) so a serving process just deserializes and calls.

The reference toolkit has no serving story — its artifact is a text
report (main-cli.c:246-320). This module makes the compiled *program*
the artifact.

Typical flow::

    blob = export_spmv(csr)             # encode-time, once
    Path("spmv.jaxexport").write_bytes(blob)
    ...
    call = import_program(blob)          # serving process
    y = call(x)
"""

from __future__ import annotations

import os
from typing import Callable

import jax
import jax.numpy as jnp

__all__ = [
    "export_program",
    "import_program",
    "export_spmv",
    "save_program",
    "load_program",
    "write_blob",
]


def export_program(fn: Callable, *example_args) -> bytes:
    """Serialize ``jit(fn)`` lowered for the example arguments' shapes.

    ``example_args`` may be arrays or ``jax.ShapeDtypeStruct``s; only
    shapes/dtypes matter. Anything ``fn`` closes over (encoded matrix
    planes, solver constants) is baked into the module.
    """
    shapes = tuple(
        jax.ShapeDtypeStruct(a.shape, a.dtype)
        if not isinstance(a, jax.ShapeDtypeStruct)
        else a
        for a in example_args
    )
    exp = jax.export.export(jax.jit(fn))(*shapes)
    return exp.serialize()


def import_program(blob: bytes) -> Callable:
    """Deserialize an exported program into a callable.

    The callable validates argument shapes/dtypes against the export and
    runs the precompiled module — no tracing, no Python math, no
    dependency on the encoding code.
    """
    exp = jax.export.deserialize(blob)
    return exp.call


def export_spmv(matrix, kernel=None, x_dtype=None) -> bytes:
    """Export ``x -> A·x`` with the encoded matrix baked in.

    ``kernel`` defaults to the XLA kernel matching the matrix's format
    (CSR/TJDS/COO). Library kernels (the cuSPARSE route) lower to custom
    calls that ``jax.export`` does not guarantee stable, so the exported
    program uses the XLA kernels.
    """
    if kernel is None:
        from smvp_toolkit_tpu.formats.coo import COOMatrix
        from smvp_toolkit_tpu.formats.csr import CSRMatrix
        from smvp_toolkit_tpu.formats.tjds import TJDSMatrix
        from smvp_toolkit_tpu.ops import spmv_coo, spmv_csr, spmv_tjds

        kernel = {
            CSRMatrix: spmv_csr,
            TJDSMatrix: spmv_tjds,
            COOMatrix: spmv_coo,
        }[type(matrix)]
    if x_dtype is None:
        # inexact covers complex64 too — a complex matrix must bake a
        # complex input signature or the program can never be served.
        x_dtype = (
            matrix.vals.dtype
            if jnp.issubdtype(matrix.vals.dtype, jnp.inexact)
            else jnp.float32
        )
    n = matrix.shape[1]
    return export_program(
        lambda x: kernel(matrix, x), jax.ShapeDtypeStruct((n,), x_dtype)
    )


def write_blob(path: str, blob: bytes) -> None:
    """Write an artifact atomically (tmp file + rename) — a crash
    mid-write must not leave a truncated, undeserializable file."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(blob)
    os.replace(tmp, path)


def save_program(path: str, fn: Callable, *example_args) -> None:
    """Export and write to ``path`` (atomic rename)."""
    write_blob(path, export_program(fn, *example_args))


def load_program(path: str) -> Callable:
    with open(path, "rb") as f:
        return import_program(f.read())
