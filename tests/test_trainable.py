"""Trainable sparse operators: value-gradients through the kernels.

The encoded values are ordinary array leaves of the format pytrees, so
``jax.grad`` of any SpMV with respect to them (and to x) is JAX's own
autodiff: a gather for d/dvals, a scatter-add for Aᵀg. Covers the XLA
CSR/TJDS kernels, the cuSPARSE route and the XLA edge-training step
(models/graph.gcn_train_step_edges). The reference toolkit has no
training story at all (main-cli.c stops at y = A·x); these tests pin the
bilinear-cotangent math against dense float64 references.
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
    spmv_csr,
    spmv_csr_cusparse,
    spmv_tjds,
)
from smvp_toolkit_tpu.utils.synth import synth_banded

OPS = {
    "csr": (csr_encode, spmv_csr),
    "cusparse": (csr_encode, spmv_csr_cusparse),
    "tjds": (tjds_encode, spmv_tjds),
}


def _dense(coo):
    r, c, v = coo.to_numpy()
    a = np.zeros(coo.shape, dtype=np.float64)
    np.add.at(a, (r, c), v)
    return a


def _rand_coo(nrows, ncols, nnz, seed, with_dups=False):
    rng = np.random.default_rng(seed)
    r = rng.integers(0, nrows, nnz).astype(np.int32)
    c = rng.integers(0, ncols, nnz).astype(np.int32)
    if with_dups:  # force exact (row, col) duplicates
        r[: nnz // 4] = r[nnz // 4: nnz // 2]
        c[: nnz // 4] = c[nnz // 4: nnz // 2]
    v = rng.standard_normal(nnz).astype(np.float32)
    return COOMatrix.from_numpy(r, c, v, shape=(nrows, ncols), pad_to=64)


def _entries(enc):
    """(row, col) of every stored slot in the encoding's value order;
    padding slots get row == nrows (they feed no output row)."""
    if hasattr(enc, "row_ptr"):
        ptr = np.asarray(enc.row_ptr)
        rows = np.full(enc.nnz_padded, enc.shape[0])
        rows[: enc.nnz] = np.repeat(np.arange(enc.shape[0]), np.diff(ptr))
        return rows, np.asarray(enc.col_ind)
    cols = np.asarray(enc.perm)[np.asarray(enc.offsets)]
    return np.asarray(enc.row_ind), cols


_MAKES = [
    lambda: synth_banded(300, nnz_per_row=6, bandwidth=20, seed=1),
    lambda: _rand_coo(200, 330, 900, seed=7),          # rectangular
    lambda: _rand_coo(150, 150, 600, seed=8, with_dups=True),
]


@pytest.mark.parametrize("op", sorted(OPS))
@pytest.mark.parametrize("make", _MAKES, ids=["banded", "rect", "dups"])
def test_value_and_x_grads_match_dense(make, op):
    coo = make()
    encode, spmv = OPS[op]
    enc = encode(coo)
    a = _dense(coo)
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal(coo.shape[1]).astype(np.float32))

    def loss(vv, xx):
        return jnp.sum(spmv(dataclasses.replace(enc, vals=vv), xx) ** 2)

    gv, gx = jax.grad(loss, argnums=(0, 1))(enc.vals, x)
    xh = np.asarray(x, np.float64)
    g_out = np.append(2 * (a @ xh), 0.0)  # padding rows -> 0 cotangent
    rows, cols = _entries(enc)
    gv_ref = g_out[rows] * xh[cols]
    gx_ref = a.T @ g_out[:-1]
    assert gv.shape == enc.vals.shape
    assert np.abs(np.asarray(gv) - gv_ref).max() / (
        np.abs(gv_ref).max() + 1e-9) < 1e-5
    assert np.abs(np.asarray(gx) - gx_ref).max() / (
        np.abs(gx_ref).max() + 1e-9) < 1e-5


@pytest.mark.parametrize("op", ["csr", "tjds"])
def test_value_grads_bf16_storage(op):
    coo = synth_banded(256, nnz_per_row=4, bandwidth=8, seed=9,
                       dtype=jnp.bfloat16).pad(64)
    encode, spmv = OPS[op]
    enc = encode(coo)
    a = _dense(coo)
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.standard_normal(coo.shape[1]).astype(np.float32))
    gv = jax.grad(
        lambda vv: jnp.sum(spmv(dataclasses.replace(enc, vals=vv), x) ** 2)
    )(enc.vals)
    assert gv.dtype == jnp.bfloat16
    xh = np.asarray(x, np.float64)
    rows, cols = _entries(enc)
    gv_ref = np.append(2 * (a @ xh), 0.0)[rows] * xh[cols]
    # bf16 storage: ~3 decimal digits on each factor of the cotangent.
    scale = np.abs(gv_ref).max() + 1e-9
    assert np.abs(np.asarray(gv, np.float64) - gv_ref).max() / scale < 0.05


@pytest.mark.parametrize("op", sorted(OPS))
def test_padding_slots_get_zero_value_grad(op):
    """Padding entries feed no row: their cotangent is exactly 0, while
    every stored entry carries the true derivative g[row]·x[col]."""
    coo = _rand_coo(190, 210, 700, seed=10)
    encode, spmv = OPS[op]
    enc = encode(coo)
    assert enc.vals.shape[0] > coo.nnz  # precondition: padded
    rng = np.random.default_rng(2)
    x = jnp.asarray(rng.standard_normal(coo.shape[1]).astype(np.float32))
    g = jnp.asarray(rng.standard_normal(coo.shape[0]).astype(np.float32))
    _, vjp = jax.vjp(
        lambda vv: spmv(dataclasses.replace(enc, vals=vv), x), enc.vals
    )
    (gv,) = vjp(g)
    gv = np.asarray(gv)
    rows, cols = _entries(enc)
    live = rows < coo.shape[0]
    assert np.all(gv[~live] == 0.0)
    ref = np.asarray(g, np.float64)[rows[live]] * np.asarray(x)[cols[live]]
    assert np.abs(gv[live] - ref).max() / (np.abs(ref).max() + 1e-9) < 1e-5


def test_gcn_train_step_edges_learns():
    from smvp_toolkit_tpu.models.graph import (
        gcn_init,
        gcn_norm,
        gcn_train_step_edges,
    )

    coo = synth_banded(256, nnz_per_row=4, bandwidth=10, seed=12)
    s = gcn_norm(coo)
    rng = np.random.default_rng(3)
    h = jnp.asarray(rng.standard_normal((256, 16)).astype(np.float32))
    labels = jnp.asarray(rng.integers(0, 4, 256).astype(np.int32))
    mask = jnp.ones((256,), jnp.float32)
    params = gcn_init(jax.random.PRNGKey(0), (16, 8, 4))
    ev = s.vals

    step = jax.jit(
        lambda p, e: gcn_train_step_edges(s, p, e, h, labels, mask,
                                          lr=5e-2, edge_lr=5e-2)
    )
    losses = []
    for _ in range(12):
        params, ev, loss = step(params, ev)
        losses.append(float(loss))
    assert losses[-1] < losses[0]          # both parameter sets learn
    assert not np.allclose(np.asarray(ev), np.asarray(s.vals))
    # Padded CSR entries aggregate into no row -> zero grad -> unchanged.
    if s.vals.shape[0] > s.nnz:
        np.testing.assert_array_equal(
            np.asarray(ev)[s.nnz:], np.asarray(s.vals)[s.nnz:]
        )


@pytest.mark.parametrize("batched", ["vmap", "spmm"])
def test_multi_rhs_value_grads(batched):
    # Multi-RHS training: Y = A(v)·X either as vmap over columns of the
    # SpMV or as the k-wide SpMM; the v-cotangent sums over the batch.
    coo = synth_banded(300, nnz_per_row=6, bandwidth=20, seed=1)
    csr = csr_encode(coo)
    rng = np.random.default_rng(0)
    x_blk = jnp.asarray(
        rng.standard_normal((coo.shape[1], 4)).astype(np.float32)
    )
    if batched == "vmap":
        fm = jax.vmap(lambda m, xx: spmv_csr(m, xx), in_axes=(None, 1),
                      out_axes=1)
    else:
        fm = spmm_csr
    gv, gx = jax.grad(
        lambda vv, xx: jnp.sum(
            fm(dataclasses.replace(csr, vals=vv), xx) ** 2),
        argnums=(0, 1),
    )(csr.vals, x_blk)
    a = _dense(coo)
    xh = np.asarray(x_blk, np.float64)
    g_out = 2 * (a @ xh)
    rows, cols = _entries(csr)
    live = rows < coo.shape[0]
    gv_ref = (g_out[rows[live], :] * xh[cols[live], :]).sum(axis=1)
    gx_ref = a.T @ g_out
    assert np.abs(np.asarray(gv)[live] - gv_ref).max() / (
        np.abs(gv_ref).max() + 1e-9
    ) < 1e-5
    assert np.abs(np.asarray(gx) - gx_ref).max() / (
        np.abs(gx_ref).max() + 1e-9
    ) < 1e-5


def test_value_vector_trains_with_optax():
    # The edge-value vector is a first-class optax parameter.
    import optax

    coo = synth_banded(256, nnz_per_row=4, bandwidth=8, seed=2)
    csr = csr_encode(coo)
    x = jnp.asarray(
        np.random.default_rng(1).standard_normal(coo.shape[1]).astype(
            np.float32
        )
    )

    def loss(vv):
        return jnp.sum(
            (spmv_csr(dataclasses.replace(csr, vals=vv), x) - 1.0) ** 2)

    tx = optax.adam(1e-2)
    state = tx.init(csr.vals)

    @jax.jit
    def step(vv, st):
        val, g = jax.value_and_grad(loss)(vv)
        upd, st = tx.update(g, st, vv)
        return optax.apply_updates(vv, upd), st, val

    l0 = float(loss(csr.vals))
    vv = csr.vals
    for _ in range(20):
        vv, state, _ = step(vv, state)
    assert float(loss(vv)) < l0
