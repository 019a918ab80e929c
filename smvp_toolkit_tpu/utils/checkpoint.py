"""Checkpoint: save/load encoded matrices to .npz archives.

The reference has no persistence beyond its report files (SURVEY.md §5
"Checkpoint / resume: none"); this is the new capability: encode once,
store the compressed representation, reload it bit-exactly on any host —
the amortization that matters when encoding large matrices for repeated
production SpMV runs.

Stored arrays carry exactly the compressed footprint (CSR: row_ptr +
col_ind + vals; TJDS adds start_pos/perm) plus shape metadata; loading
reconstructs the pytree dataclasses with device arrays.
"""

from __future__ import annotations

import io
import json
from typing import Union

import jax.numpy as jnp
import numpy as np

from smvp_toolkit_tpu.formats.coo import COOMatrix
from smvp_toolkit_tpu.formats.csr import CSRMatrix
from smvp_toolkit_tpu.formats.tjds import TJDSMatrix
from smvp_toolkit_tpu.io.mtx import MMTypeCode

__all__ = ["save_matrix", "load_matrix", "save_hierarchy", "load_hierarchy"]

_KINDS = {"COOMatrix": COOMatrix, "CSRMatrix": CSRMatrix, "TJDSMatrix": TJDSMatrix}


def save_matrix(dest, matrix: Union[COOMatrix, CSRMatrix, TJDSMatrix]) -> None:
    """Serialize an encoded matrix (or COO) to an ``.npz`` archive."""
    kind = type(matrix).__name__
    if kind not in _KINDS:
        raise TypeError(f"cannot checkpoint {kind}")
    meta = {"kind": kind, "shape": list(matrix.shape), "nnz": int(matrix.nnz)}
    arrays = {}
    if isinstance(matrix, COOMatrix):
        meta["typecode"] = str(matrix.typecode)
        arrays = {
            "rows": np.asarray(matrix.rows),
            "cols": np.asarray(matrix.cols),
            "vals": np.asarray(matrix.vals),
        }
    elif isinstance(matrix, CSRMatrix):
        arrays = {
            "row_ptr": np.asarray(matrix.row_ptr),
            "col_ind": np.asarray(matrix.col_ind),
            "vals": np.asarray(matrix.vals),
        }
    elif isinstance(matrix, TJDSMatrix):
        arrays = {
            "vals": np.asarray(matrix.vals),
            "row_ind": np.asarray(matrix.row_ind),
            "start_pos": np.asarray(matrix.start_pos),
            "perm": np.asarray(matrix.perm),
            "offsets": np.asarray(matrix.offsets),
            "num_diags": np.asarray(matrix.num_diags),
        }
    arrays["__meta__"] = np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8
    )
    np.savez_compressed(dest, **arrays)


def load_matrix(source) -> Union[COOMatrix, CSRMatrix, TJDSMatrix]:
    """Load a matrix checkpoint written by :func:`save_matrix`."""
    with np.load(source) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        kind = meta["kind"]
        shape = tuple(meta["shape"])
        nnz = int(meta["nnz"])
        if kind == "COOMatrix":
            parts = meta.get("typecode", "matrix coordinate real general").split()
            return COOMatrix(
                rows=jnp.asarray(z["rows"]),
                cols=jnp.asarray(z["cols"]),
                vals=jnp.asarray(z["vals"]),
                shape=shape,
                nnz=nnz,
                typecode=MMTypeCode(*parts),
            )
        if kind == "CSRMatrix":
            return CSRMatrix(
                row_ptr=jnp.asarray(z["row_ptr"]),
                col_ind=jnp.asarray(z["col_ind"]),
                vals=jnp.asarray(z["vals"]),
                shape=shape,
                nnz=nnz,
            )
        if kind == "TJDSMatrix":
            return TJDSMatrix(
                vals=jnp.asarray(z["vals"]),
                row_ind=jnp.asarray(z["row_ind"]),
                start_pos=jnp.asarray(z["start_pos"]),
                perm=jnp.asarray(z["perm"]),
                offsets=jnp.asarray(z["offsets"]),
                num_diags=jnp.asarray(z["num_diags"]),
                shape=shape,
                nnz=nnz,
            )
    raise ValueError(f"unknown checkpoint kind {kind!r}")


def save_hierarchy(dest, levels) -> None:
    """Serialize an AMG hierarchy (models/amg.amg_setup) to one .npz.

    Setup is the expensive half (tens of seconds at 10M nnz — strength
    graph, aggregation, Galerkin SpGEMM); encode-once deployments
    reload the kernel-ready level operators directly and rebuild the
    preconditioner with ``amg_preconditioner(None, levels=...)``-style
    reuse via the ``levels=`` argument.
    """
    meta = {"kind": "AMGHierarchy", "levels": []}
    arrays = {}

    def _put(prefix, mat):
        arrays[f"{prefix}_row_ptr"] = np.asarray(mat.row_ptr)
        arrays[f"{prefix}_col_ind"] = np.asarray(mat.col_ind)
        arrays[f"{prefix}_vals"] = np.asarray(mat.vals)
        return {"shape": list(mat.shape), "nnz": int(mat.nnz)}

    for li, lv in enumerate(levels):
        entry = {"n": int(lv.n), "omega": float(lv.omega),
                 "rho": float(lv.rho)}
        if lv.coarse_inv is not None:
            arrays[f"l{li}_coarse_inv"] = np.asarray(lv.coarse_inv)
        else:
            entry["a"] = _put(f"l{li}_a", lv.a_csr)
            entry["p"] = _put(f"l{li}_p", lv.p_csr)
            entry["pt"] = _put(f"l{li}_pt", lv.pt_csr)
            arrays[f"l{li}_inv_diag"] = np.asarray(lv.inv_diag)
        meta["levels"].append(entry)
    arrays["__meta__"] = np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8
    )
    np.savez(dest, **arrays)


def load_hierarchy(source):
    """Load an AMG hierarchy written by :func:`save_hierarchy`."""
    from smvp_toolkit_tpu.models.amg import AMGLevel

    with np.load(source) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        if meta.get("kind") != "AMGHierarchy":
            raise TypeError(f"not an AMG hierarchy: {meta.get('kind')}")

        def _get(prefix, spec):
            # with_row_ids: fresh encodes carry the row-id cache that
            # spmv_csr consumes; without it every reloaded level apply
            # would re-derive row ids inside the jitted solve loop.
            return CSRMatrix(
                row_ptr=jnp.asarray(z[f"{prefix}_row_ptr"]),
                col_ind=jnp.asarray(z[f"{prefix}_col_ind"]),
                vals=jnp.asarray(z[f"{prefix}_vals"]),
                shape=tuple(spec["shape"]),
                nnz=int(spec["nnz"]),
            ).with_row_ids()

        levels = []
        for li, entry in enumerate(meta["levels"]):
            if f"l{li}_coarse_inv" in z:
                levels.append(AMGLevel(
                    n=int(entry["n"]),
                    coarse_inv=jnp.asarray(z[f"l{li}_coarse_inv"]),
                ))
            else:
                levels.append(AMGLevel(
                    n=int(entry["n"]),
                    a_csr=_get(f"l{li}_a", entry["a"]),
                    p_csr=_get(f"l{li}_p", entry["p"]),
                    pt_csr=_get(f"l{li}_pt", entry["pt"]),
                    inv_diag=jnp.asarray(z[f"l{li}_inv_diag"]),
                    omega=float(entry["omega"]),
                    rho=float(entry["rho"]),
                ))
        return levels
