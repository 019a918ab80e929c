"""Seeded property sweep of the device SpMV/SpMM operators.

Random shapes (tall, wide, ultra-sparse, dense-ish with duplicates, a
single entry, empty rows and columns), each operator against a float64
dense oracle: CSR (segment-sum and cumsum), TJDS, COO, the cuSPARSE
route (JAX's generic lowering off the GPU), the k-wide SpMMs and the
sharded SpMMs. Fully deterministic (seeded per case).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from smvp_toolkit_tpu.formats.coo import COOMatrix
from smvp_toolkit_tpu.formats.csr import csr_encode
from smvp_toolkit_tpu.formats.tjds import tjds_encode
from smvp_toolkit_tpu.ops import (
    spmm_csr,
    spmm_tjds,
    spmv_coo,
    spmv_csr,
    spmv_csr_cumsum,
    spmv_csr_cusparse,
    spmv_tjds,
)

# (seed, nrows, ncols, nnz, duplicates)
_CASES = [
    (0, 513, 129, 3000, False),
    (1, 129, 513, 3000, False),
    (2, 1000, 1000, 50, False),     # ultra-sparse: mostly empty rows
    (3, 64, 64, 4000, True),        # dense-ish, many duplicates
    (4, 2048, 100, 6000, True),     # tall
    (5, 100, 2048, 6000, False),    # wide
    (6, 300, 300, 1, False),        # single entry
    (7, 555, 444, 2500, True),
]
_IDS = [f"case{c[0]}" for c in _CASES]

_SPMV = {
    "coo": (lambda coo: coo, spmv_coo),
    "csr": (csr_encode, spmv_csr),
    "csr_cumsum": (csr_encode, spmv_csr_cumsum),
    "cusparse": (csr_encode, spmv_csr_cusparse),
    "tjds": (tjds_encode, spmv_tjds),
}
_SPMM = {
    "csr": (csr_encode, spmm_csr),
    "tjds": (tjds_encode, spmm_tjds),
}


def _case(seed, n, m, nnz, dups):
    rng = np.random.RandomState(seed)
    if dups:
        r = rng.randint(0, n, nnz)
        c = rng.randint(0, m, nnz)
    else:
        flat = rng.choice(n * m, size=min(nnz, n * m), replace=False)
        r, c = np.divmod(flat, m)
    v = rng.randn(len(r))
    coo = COOMatrix.from_numpy(r.astype(np.int32), c.astype(np.int32), v,
                               shape=(n, m), pad_to=64)
    dense = np.zeros((n, m))
    np.add.at(dense, (r, c), coo.to_numpy()[2].astype(np.float64))
    return coo, dense, rng


def _rel(got, ref):
    return np.abs(np.asarray(got, np.float64) - ref).max() / max(
        np.abs(ref).max(), 1e-9)


@pytest.mark.parametrize("op", sorted(_SPMV))
@pytest.mark.parametrize("case", _CASES, ids=_IDS)
def test_spmv_matches_dense(case, op):
    coo, dense, rng = _case(*case)
    encode, spmv = _SPMV[op]
    x = rng.randn(coo.shape[1]).astype(np.float32)
    y = spmv(encode(coo), jnp.asarray(x))
    assert y.shape == (coo.shape[0],)
    # cumsum rounds a global prefix of up to 6000 f32 products.
    assert _rel(y, dense @ x.astype(np.float64)) < (
        1e-4 if op == "csr_cumsum" else 2e-5)


@pytest.mark.parametrize("op", sorted(_SPMM))
@pytest.mark.parametrize("case", _CASES, ids=_IDS)
def test_spmm_matches_dense(case, op):
    coo, dense, rng = _case(*case)
    encode, spmm = _SPMM[op]
    X = rng.randn(coo.shape[1], 5).astype(np.float32)
    Y = spmm(encode(coo), jnp.asarray(X))
    assert Y.shape == (coo.shape[0], 5)
    assert _rel(Y, dense @ X.astype(np.float64)) < 2e-5


@pytest.mark.parametrize("op", ["csr", "cusparse"])
@pytest.mark.parametrize("case", _CASES, ids=_IDS)
def test_grad_x_is_transpose_product(case, op):
    """d/dx of g·(A x) is Aᵀg (a scatter-add over col_ind)."""
    coo, dense, rng = _case(*case)
    encode, spmv = _SPMV[op]
    csr = encode(coo)
    x = jnp.asarray(rng.randn(coo.shape[1]).astype(np.float32))
    g = rng.randn(coo.shape[0]).astype(np.float32)
    gx = jax.grad(lambda xx: jnp.vdot(jnp.asarray(g), spmv(csr, xx)))(x)
    assert _rel(gx, dense.T @ g.astype(np.float64)) < 2e-5


@pytest.mark.parametrize("case", _CASES, ids=_IDS)
def test_sharded_spmm_matches_dense(case):
    from smvp_toolkit_tpu.parallel import (
        make_mesh,
        shard_csr,
        spmm_csr_sharded,
    )

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 (virtual) devices")
    coo, dense, rng = _case(*case)
    mesh = make_mesh(4)
    sh = shard_csr(csr_encode(coo), mesh, balance="nnz")
    X = rng.randn(coo.shape[1], 3).astype(np.float32)
    Y = spmm_csr_sharded(sh, jnp.asarray(X), mesh)
    assert _rel(Y, dense @ X.astype(np.float64)) < 2e-5


@pytest.mark.parametrize("scale", [1e-30, 1.0, 1e30])
@pytest.mark.parametrize("op", ["csr", "tjds", "cusparse"])
def test_extreme_value_magnitudes(scale, op):
    """Values near f32's range ends survive (no flush, no overflow on
    the way through the gather and the reduction)."""
    coo, dense, rng = _case(11, 200, 200, 800, False)
    encode, spmv = _SPMV[op]
    enc = encode(coo)
    enc = dataclasses.replace(enc, vals=enc.vals * np.float32(scale))
    x = rng.uniform(0.5, 1.0, coo.shape[1]).astype(np.float32)
    y = np.asarray(spmv(enc, jnp.asarray(x)), np.float64)
    assert np.isfinite(y).all()
    ref = (dense * scale) @ x.astype(np.float64)
    assert _rel(y, ref) < 2e-5


def test_cusparse_refuses_unsupported_dtype():
    """bf16 values have no cuSPARSE route: refused, never silently
    lowered to the generic kernel."""
    coo, _, _ = _case(12, 50, 50, 200, False)
    csr = csr_encode(coo)
    csr16 = dataclasses.replace(csr, vals=csr.vals.astype(jnp.bfloat16))
    with pytest.raises(TypeError, match="cuSPARSE"):
        spmv_csr_cusparse(csr16, jnp.ones((50,), jnp.bfloat16))
