"""COO (coordinate) sparse matrix — the interchange format.

Device analog of the reference's ``MMRawData`` triplet array
(main-cli.c:42-47). Differences by design:

* Structure-of-arrays (``rows``/``cols``/``vals`` as separate device
  arrays) instead of an array-of-structs — XLA wants flat, contiguous,
  independently-typed buffers.
* Static padded shapes: device arrays may be padded to a block multiple so
  downstream jitted encoders/kernels see stable shapes; ``nnz`` carries the
  true count. Padding rows use the out-of-range sentinel ``row == nrows``
  (sorts last, dropped by segment-sum) and ``val == 0``.
* Registered as a JAX pytree, so a ``COOMatrix`` can flow through ``jit``,
  ``shard_map`` and ``jax.tree_util`` transparently.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from smvp_toolkit_tpu.io.mtx import MMTypeCode

__all__ = ["COOMatrix"]


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class COOMatrix:
    """Sparse matrix in coordinate (triplet) form.

    ``rows``/``cols`` are int32, ``vals`` any float dtype (default f32 on
    device). Entries beyond ``nnz`` are padding (``rows == nrows``,
    ``vals == 0``).
    """

    rows: jax.Array
    cols: jax.Array
    vals: jax.Array
    shape: Tuple[int, int] = dataclasses.field(metadata=dict(static=True))
    nnz: int = dataclasses.field(metadata=dict(static=True))
    typecode: MMTypeCode = dataclasses.field(
        default=MMTypeCode(), metadata=dict(static=True)
    )

    # ------------------------------------------------------------------
    # Construction
    # ------------------------------------------------------------------
    @staticmethod
    def from_numpy(
        r: np.ndarray,
        c: np.ndarray,
        v: np.ndarray,
        *,
        shape: Tuple[int, int],
        typecode: Optional[MMTypeCode] = None,
        dtype=None,
        pad_to: Optional[int] = None,
    ) -> "COOMatrix":
        """Build a device COO from host triplets (file order preserved)."""
        nnz = int(len(r))
        if dtype is None:
            dtype = jnp.float32
        r = np.asarray(r, dtype=np.int32)
        c = np.asarray(c, dtype=np.int32)
        v = np.asarray(v)
        if pad_to is not None and pad_to > 1:
            total = max(_round_up(max(nnz, 1), pad_to), pad_to)
            if total > nnz:
                pad = total - nnz
                r = np.concatenate([r, np.full(pad, shape[0], dtype=np.int32)])
                c = np.concatenate([c, np.zeros(pad, dtype=np.int32)])
                v = np.concatenate([v, np.zeros(pad, dtype=v.dtype)])
        # Downcast host-side so jnp.asarray does not warn about f64
        # truncation (f32-on-device is the documented default).
        v_host = np.asarray(v, dtype=jnp.dtype(dtype))
        return COOMatrix(
            rows=jnp.asarray(r),
            cols=jnp.asarray(c),
            vals=jnp.asarray(v_host),
            shape=(int(shape[0]), int(shape[1])),
            nnz=nnz,
            typecode=typecode or MMTypeCode(),
        )

    @staticmethod
    def from_scipy(
        mat,
        *,
        typecode: Optional[MMTypeCode] = None,
        dtype=None,
        pad_to: Optional[int] = None,
    ) -> "COOMatrix":
        """Build from any ``scipy.sparse`` matrix/array (interop bridge).

        Users migrating from the reference toolkit typically hold their
        matrices as scipy objects; any format with ``.tocoo()`` works.
        Duplicate entries are preserved (both libraries sum them on
        materialization). Complex inputs promote to complex64 unless
        ``dtype`` says otherwise.
        """
        coo = mat.tocoo()
        if dtype is None and np.iscomplexobj(coo.data):
            dtype = jnp.complex64
        return COOMatrix.from_numpy(
            coo.row,
            coo.col,
            coo.data,
            shape=coo.shape,
            typecode=typecode,
            dtype=dtype,
            pad_to=pad_to,
        )

    def _export_triplets(self):
        """Triplets prepared for ecosystems without symmetry metadata.

        Non-general typecodes store only one triangle; scipy/torch have
        no banner to carry that, so export must expand to the full
        matrix or it silently hands over a wrong operator. Values in
        dtypes numpy's ecosystem peers reject (bfloat16 etc.) upcast to
        float32.
        """
        r, c, v = self.to_numpy()
        if not self.typecode.is_general:
            from smvp_toolkit_tpu.io.mtx import expand_symmetric

            r, c, v = expand_symmetric(self.typecode, r, c, v)
        v = np.asarray(v)
        if v.dtype.kind not in "fciu":  # ml_dtypes (bfloat16, ...)
            v = v.astype(np.float32)
        return r, c, v

    def to_scipy(self):
        """True (unpadded) entries as a ``scipy.sparse.coo_matrix``.

        Symmetric/skew/hermitian storage is expanded to the full matrix
        (scipy carries no symmetry metadata); bfloat16 values upcast to
        float32.
        """
        import scipy.sparse

        r, c, v = self._export_triplets()
        return scipy.sparse.coo_matrix((v, (r, c)), shape=self.shape)

    @staticmethod
    def from_bcoo(
        mat,
        *,
        typecode: Optional[MMTypeCode] = None,
        dtype=None,
        pad_to: Optional[int] = None,
    ) -> "COOMatrix":
        """Build from a ``jax.experimental.sparse.BCOO`` matrix.

        The in-ecosystem bridge: JAX users holding BCOO operators can
        route them onto this framework's encoders/kernels without
        leaving device-array land. Only plain 2-D matrices (no batch or
        dense trailing dims) map onto a sparse matrix codec. BCOO marks
        padding with out-of-range indices — those slots are dropped
        (this framework's padding sentinel differs: ``row == nrows``
        with ``val == 0``). Duplicates are preserved (both sides sum
        them on materialization). The value dtype is preserved unless
        ``dtype`` overrides it.
        """
        if mat.ndim != 2 or mat.n_batch or mat.n_dense:
            raise ValueError(
                "only plain 2-D BCOO (n_batch=0, n_dense=0) converts to "
                f"a sparse matrix; got ndim={mat.ndim}, "
                f"n_batch={mat.n_batch}, n_dense={mat.n_dense}"
            )
        idx = np.asarray(mat.indices)
        data = np.asarray(mat.data)
        keep = (idx[:, 0] < mat.shape[0]) & (idx[:, 1] < mat.shape[1])
        if not bool(keep.all()):
            idx, data = idx[keep], data[keep]
        return COOMatrix.from_numpy(
            idx[:, 0],
            idx[:, 1],
            data,
            shape=mat.shape,
            typecode=typecode,
            dtype=mat.dtype if dtype is None else dtype,
            pad_to=pad_to,
        )

    def to_bcoo(self):
        """True (unpadded) entries as ``jax.experimental.sparse.BCOO``.

        Symmetric/skew/hermitian storage is expanded to the full matrix
        (BCOO carries no symmetry metadata); the value dtype is
        preserved (BCOO is JAX-native, so bfloat16 needs no upcast).
        """
        from jax.experimental import sparse as jsparse

        r, c, v = self.to_numpy()
        if not self.typecode.is_general:
            from smvp_toolkit_tpu.io.mtx import expand_symmetric

            r, c, v = expand_symmetric(self.typecode, r, c, v)
        indices = jnp.stack(
            [
                jnp.asarray(np.asarray(r, np.int32)),
                jnp.asarray(np.asarray(c, np.int32)),
            ],
            axis=1,
        )
        return jsparse.BCOO(
            (jnp.asarray(v), indices), shape=self.shape
        )

    @staticmethod
    def from_torch(
        tensor,
        *,
        typecode: Optional[MMTypeCode] = None,
        dtype=None,
        pad_to: Optional[int] = None,
    ) -> "COOMatrix":
        """Build from a ``torch`` tensor (sparse COO/CSR/CSC or dense).

        Sparse inputs are coalesced first (torch sums duplicates there,
        matching materialization semantics); dense inputs keep explicit
        zeros out. CPU copies only — the device hop happens in
        :meth:`from_numpy`.
        """
        import torch

        t = tensor.detach().cpu()
        if t.layout != torch.sparse_coo:
            t = t.to_sparse_coo()
        t = t.coalesce()
        idx = t.indices().numpy()
        vals = t.values().numpy()
        if dtype is None and np.iscomplexobj(vals):
            dtype = jnp.complex64
        return COOMatrix.from_numpy(
            idx[0],
            idx[1],
            vals,
            shape=tuple(t.shape),
            typecode=typecode,
            dtype=dtype,
            pad_to=pad_to,
        )

    def to_torch(self):
        """True (unpadded) entries as a coalesced torch sparse tensor.

        Same export rules as :meth:`to_scipy`: symmetry expanded,
        bfloat16 upcast to float32.
        """
        import torch

        r, c, v = self._export_triplets()
        # Explicit invariant checks: export is not a hot path, and the
        # opt-in silences torch's implicit-disable warning.
        return torch.sparse_coo_tensor(
            np.stack([r, c]).astype(np.int64), v, size=self.shape,
            check_invariants=True,
        ).coalesce()

    # ------------------------------------------------------------------
    # Properties
    # ------------------------------------------------------------------
    @property
    def nnz_padded(self) -> int:
        return int(self.rows.shape[0])

    @property
    def dtype(self):
        return self.vals.dtype

    @property
    def nrows(self) -> int:
        return self.shape[0]

    @property
    def ncols(self) -> int:
        return self.shape[1]

    # ------------------------------------------------------------------
    # Transformations
    # ------------------------------------------------------------------
    def pad(self, multiple: int) -> "COOMatrix":
        """Pad the nnz dimension to a multiple (static-shape discipline)."""
        total = max(_round_up(max(self.nnz, 1), multiple), multiple)
        cur = self.nnz_padded
        if total <= cur:
            return self
        extra = total - cur
        rows = jnp.concatenate(
            [self.rows, jnp.full((extra,), self.shape[0], dtype=jnp.int32)]
        )
        cols = jnp.concatenate([self.cols, jnp.zeros((extra,), dtype=jnp.int32)])
        vals = jnp.concatenate([self.vals, jnp.zeros((extra,), dtype=self.dtype)])
        return dataclasses.replace(self, rows=rows, cols=cols, vals=vals)

    def canonical_order(self) -> "COOMatrix":
        """Sort entries row-major (row, then col); padding stays last.

        The canonical order used to define decode bit-exactness — the
        reference's CSR encoder uses the same (row, col) qsort
        (main-cli.c:340 with comparator main-cli.c:171-188).
        """
        r = np.asarray(self.rows)
        c = np.asarray(self.cols)
        v = np.asarray(self.vals)
        order = np.lexsort((c, r))
        return dataclasses.replace(
            self,
            rows=jnp.asarray(r[order]),
            cols=jnp.asarray(c[order]),
            vals=jnp.asarray(v[order]),
        )

    # ------------------------------------------------------------------
    # Host-side views / oracles
    # ------------------------------------------------------------------
    def to_numpy(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Return the true (unpadded) triplets as numpy arrays."""
        return (
            np.asarray(self.rows)[: self.nnz],
            np.asarray(self.cols)[: self.nnz],
            np.asarray(self.vals)[: self.nnz],
        )

    def to_dense(self, dtype=np.float64) -> np.ndarray:
        """Dense host oracle (duplicates are summed, per MatrixMarket)."""
        r, c, v = self.to_numpy()
        dense = np.zeros(self.shape, dtype=dtype)
        np.add.at(dense, (r, c), v.astype(dtype))
        return dense

    def __repr__(self) -> str:
        return (
            f"COOMatrix(shape={self.shape}, nnz={self.nnz}, "
            f"padded={self.nnz_padded}, dtype={self.dtype}, "
            f"typecode='{self.typecode}')"
        )
