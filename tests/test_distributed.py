"""Data-parallel SpMV tests on an 8-device CPU-simulated mesh.

Per SURVEY.md §4: multi-device behavior is validated via
``--xla_force_host_platform_device_count=8`` (set in conftest) +
shard_map, so no GPU cluster is needed in CI.
"""

import os

import numpy as np
import pytest

import jax

from smvp_toolkit_tpu.formats.coo import COOMatrix
from smvp_toolkit_tpu.formats.csr import csr_encode
from smvp_toolkit_tpu.formats.tjds import tjds_encode
from smvp_toolkit_tpu.io.mtx import read_mtx
from smvp_toolkit_tpu.parallel import (
    make_mesh,
    shard_csr,
    shard_tjds,
    spmv_csr_sharded,
    spmv_tjds_sharded,
)

from conftest import SAMPLE_DIR, random_coo


@pytest.fixture(autouse=True)
def _needs_devices():
    # Decided at run time, so every xdist worker collects the same tests.
    if len(jax.devices()) < 2:
        pytest.skip("needs multiple (virtual) devices")


def _coo(seed=0, nrows=100, ncols=90, nnz=700):
    rng = np.random.RandomState(seed)
    r, c, v = random_coo(rng, nrows, ncols, nnz)
    return COOMatrix.from_numpy(r, c, v, shape=(nrows, ncols), pad_to=64)


@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_csr_rowblock_sharding(n_shards):
    coo = _coo()
    csr = csr_encode(coo)
    mesh = make_mesh(n_shards)
    sharded = shard_csr(csr, mesh)
    rng = np.random.RandomState(1)
    x = np.asarray(rng.randn(coo.shape[1]), dtype=np.float32)
    y = np.asarray(spmv_csr_sharded(sharded, x, mesh))
    y_ref = coo.to_dense() @ x.astype(np.float64)
    assert y.shape == (coo.shape[0],)
    np.testing.assert_allclose(y, y_ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_tjds_stripe_sharding(n_shards):
    coo = _coo(seed=2)
    tj = tjds_encode(coo)
    mesh = make_mesh(n_shards)
    sharded = shard_tjds(tj, mesh)
    rng = np.random.RandomState(3)
    x = np.asarray(rng.randn(coo.shape[1]), dtype=np.float32)
    y = np.asarray(spmv_tjds_sharded(sharded, x, mesh))
    y_ref = coo.to_dense() @ x.astype(np.float64)
    np.testing.assert_allclose(y, y_ref, rtol=1e-4, atol=1e-5)


def test_uneven_rows():
    # nrows not divisible by shard count (SURVEY.md §7 hard part (d)).
    coo = _coo(seed=4, nrows=107, ncols=55, nnz=500)
    csr = csr_encode(coo)
    mesh = make_mesh(4)
    sharded = shard_csr(csr, mesh)
    x = np.ones(coo.shape[1], dtype=np.float32)
    y = np.asarray(spmv_csr_sharded(sharded, x, mesh))
    y_ref = coo.to_dense() @ np.ones(coo.shape[1])
    assert y.shape == (107,)
    np.testing.assert_allclose(y, y_ref, rtol=1e-4, atol=1e-5)


def test_empty_shard():
    # All nnz in the first rows: later shards own zero entries.
    r = np.arange(10, dtype=np.int32)
    c = np.arange(10, dtype=np.int32)
    v = np.ones(10)
    coo = COOMatrix.from_numpy(r, c, v, shape=(80, 10), pad_to=16)
    csr = csr_encode(coo)
    mesh = make_mesh(8)
    sharded = shard_csr(csr, mesh)
    x = np.ones(10, dtype=np.float32)
    y = np.asarray(spmv_csr_sharded(sharded, x, mesh))
    np.testing.assert_allclose(y[:10], np.ones(10))
    np.testing.assert_allclose(y[10:], np.zeros(70))


def test_sample_matrix_sharded():
    coo = read_mtx(
        os.path.join(SAMPLE_DIR, "curtis54.mtx"), use_native=False
    ).pad(64)
    csr = csr_encode(coo)
    tj = tjds_encode(coo)
    mesh = make_mesh(8)
    x = np.ones(coo.shape[1], dtype=np.float32)
    y1 = np.asarray(spmv_csr_sharded(shard_csr(csr, mesh), x, mesh))
    y2 = np.asarray(spmv_tjds_sharded(shard_tjds(tj, mesh), x, mesh))
    y_ref = coo.to_dense() @ np.ones(coo.shape[1])
    np.testing.assert_allclose(y1, y_ref, rtol=1e-5)
    np.testing.assert_allclose(y2, y_ref, rtol=1e-5)


def test_graft_dryrun():
    # The driver's multi-chip validation path must work end to end.
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "__graft_entry__",
        os.path.join(os.path.dirname(__file__), "..", "__graft_entry__.py"),
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.dryrun_multichip(8)
    fn, args = mod.entry()
    y = jax.jit(fn)(*args)
    assert np.isfinite(np.asarray(y)).all()


@pytest.mark.parametrize("n_shards", [2, 8])
def test_sharded_csr_nnz_balance_random(n_shards):
    coo = _coo(seed=9, nrows=260, ncols=200, nnz=1500)
    mesh = make_mesh(n_shards)
    sh = shard_csr(csr_encode(coo), mesh, balance="nnz")
    rng = np.random.RandomState(5)
    x = np.asarray(rng.randn(coo.shape[1]), dtype=np.float32)
    y = np.asarray(spmv_csr_sharded(sh, x, mesh))
    y_ref = coo.to_dense() @ x.astype(np.float64)
    np.testing.assert_allclose(y, y_ref, rtol=1e-4, atol=1e-5)


def test_sharded_memplus_nnz_balance():
    """The memplus stand-in (17,758 rows) over 4 nnz-balanced shards."""
    import scipy.sparse as sp

    coo = read_mtx(os.path.join(SAMPLE_DIR, "memplus.mtx")).pad(128)
    mesh = make_mesh(4)
    sh = shard_csr(csr_encode(coo), mesh, balance="nnz")
    x = np.random.RandomState(3).randn(coo.shape[1]).astype(np.float32)
    y = np.asarray(spmv_csr_sharded(sh, x, mesh))
    r, c, v = coo.to_numpy()
    ref = sp.csr_matrix((v.astype(np.float64), (r, c)), shape=coo.shape) @ x
    np.testing.assert_allclose(y, ref, rtol=1e-4, atol=1e-5)


def test_sharded_csr_bf16_values():
    """bf16 values shard with their dtype and match a bf16 oracle."""
    import jax.numpy as jnp
    import ml_dtypes

    mesh8 = make_mesh(8)
    rng = np.random.RandomState(13)
    nrows = 1024
    nnz = 6000
    r = rng.randint(0, nrows, nnz).astype(np.int64)
    c = rng.randint(0, nrows, nnz).astype(np.int64)
    v = rng.randn(nnz).astype(np.float32)
    coo = COOMatrix.from_numpy(r, c, v, shape=(nrows, nrows),
                               dtype=jnp.bfloat16, pad_to=64)
    sh = shard_csr(csr_encode(coo), mesh8)
    assert sh.vals.dtype == jnp.bfloat16
    x = jnp.asarray(rng.randn(nrows).astype(ml_dtypes.bfloat16))
    y = np.asarray(spmv_csr_sharded(sh, x, mesh8)).astype(np.float64)
    y_ref = np.zeros(nrows)
    np.add.at(
        y_ref, r,
        v.astype(ml_dtypes.bfloat16).astype(np.float64)
        * np.asarray(x).astype(np.float64)[c],
    )
    scale = np.abs(y_ref).max() + 1e-30
    assert np.abs(y - y_ref).max() / scale < 2e-2


# ---------------------------------------------------------------------------
# Sharded SpMM (row-block DP for dense multi-vector blocks)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_shards", [2, 8])
def test_spmm_rowblock_sharding(n_shards):
    from smvp_toolkit_tpu.parallel import spmm_csr_sharded

    coo = _coo(seed=21, nrows=97, ncols=83, nnz=500)  # uneven rows
    csr = csr_encode(coo)
    mesh = make_mesh(n_shards)
    sharded = shard_csr(csr, mesh)
    rng = np.random.RandomState(22)
    X = np.asarray(rng.randn(coo.shape[1], 16), dtype=np.float32)
    Y = np.asarray(spmm_csr_sharded(sharded, X, mesh))
    Y_ref = coo.to_dense() @ X.astype(np.float64)
    assert Y.shape == (coo.shape[0], 16)
    np.testing.assert_allclose(Y, Y_ref, rtol=1e-4, atol=1e-5)


def test_spmm_sharded_ungathered_blocks():
    from smvp_toolkit_tpu.parallel import spmm_csr_sharded

    coo = _coo(seed=23)
    csr = csr_encode(coo)
    mesh = make_mesh(4)
    sharded = shard_csr(csr, mesh)
    X = np.ones((coo.shape[1], 8), dtype=np.float32)
    Yb = np.asarray(spmm_csr_sharded(sharded, X, mesh, gather=False))
    assert Yb.shape == (4, sharded.rows_per_shard, 8)
    Y_ref = coo.to_dense() @ np.ones((coo.shape[1], 8))
    flat = Yb.reshape(-1, 8)[: coo.shape[0]]
    np.testing.assert_allclose(flat, Y_ref, rtol=1e-4, atol=1e-5)


def test_distributed_gcn_layer_matches_single_device():
    """GCN aggregation over the sharded SpMM == single-device layer."""
    from smvp_toolkit_tpu.models.graph import gcn_layer, gcn_norm
    from smvp_toolkit_tpu.parallel import spmm_csr_sharded

    import jax.numpy as jnp

    rng = np.random.RandomState(24)
    n = 60
    r, c, v = random_coo(rng, n, n, 300)
    adj = COOMatrix.from_numpy(r, c, np.abs(v), shape=(n, n), pad_to=64)
    s = gcn_norm(adj)
    mesh = make_mesh(4)
    s_sh = shard_csr(s, mesh)

    h = jnp.asarray(rng.randn(n, 12), jnp.float32)
    w = jnp.asarray(rng.randn(12, 8), jnp.float32)
    b = jnp.asarray(rng.randn(8), jnp.float32)

    y_single = np.asarray(gcn_layer(s, h, w, b))
    y_dist = np.asarray(
        jax.nn.relu(spmm_csr_sharded(s_sh, h @ w, mesh) + b)
    )
    np.testing.assert_allclose(y_dist, y_single, rtol=1e-4, atol=1e-5)


def test_distributed_gcn_train_step_matches_single_device():
    """Full DP training step: grads flow through shard_map's collective.

    One SGD step with the aggregation injected as the sharded SpMM must
    produce the same loss and updated parameters as the single-device
    step — the all-gather in the forward transposes to a reduce-scatter
    of the cotangent under jax.grad.
    """
    from smvp_toolkit_tpu.models.graph import (
        gcn_init, gcn_norm, gcn_train_step,
    )
    from smvp_toolkit_tpu.parallel import spmm_csr_sharded

    import jax.numpy as jnp

    rng = np.random.RandomState(31)
    n = 60
    r, c, v = random_coo(rng, n, n, 300)
    adj = COOMatrix.from_numpy(r, c, np.abs(v), shape=(n, n), pad_to=64)
    s = gcn_norm(adj)
    mesh = make_mesh(4)
    s_sh = shard_csr(s, mesh)

    h = jnp.asarray(rng.randn(n, 12), jnp.float32)
    labels = jnp.asarray(rng.randint(0, 4, n), jnp.int32)
    mask = jnp.asarray(rng.rand(n) < 0.5)
    params = gcn_init(jax.random.PRNGKey(0), (12, 8, 4))

    p_single, loss_single = jax.jit(
        lambda p: gcn_train_step(s, p, h, labels, mask)
    )(params)
    p_dist, loss_dist = jax.jit(
        lambda p: gcn_train_step(
            s, p, h, labels, mask,
            spmm=lambda m, z: spmm_csr_sharded(s_sh, z, mesh),
        )
    )(params)

    np.testing.assert_allclose(
        float(loss_dist), float(loss_single), rtol=1e-5
    )
    for (w1, b1), (w2, b2) in zip(p_single, p_dist):
        np.testing.assert_allclose(
            np.asarray(w2), np.asarray(w1), rtol=1e-4, atol=1e-5
        )
        np.testing.assert_allclose(
            np.asarray(b2), np.asarray(b1), rtol=1e-4, atol=1e-5
        )


@pytest.mark.parametrize("balance", ["rows", "nnz"])
def test_distributed_edge_training_matches_single_device(balance):
    """DP edge-weight training: with_vals reshards the live parameter.

    One SGD step on (layer weights, edge values) where the aggregation
    is the sharded SpMM rebuilt per step from the live entry-order
    values — must match the single-device gcn_train_step_edges exactly
    (loss, weights, and the edge-value gradient step), for both
    equal-rows and nnz-balanced block boundaries.
    """
    from smvp_toolkit_tpu.models.graph import (
        gcn_init, gcn_norm, gcn_train_step_edges,
    )
    from smvp_toolkit_tpu.parallel import spmm_csr_sharded

    import jax.numpy as jnp

    rng = np.random.RandomState(37)
    n = 60
    r, c, v = random_coo(rng, n, n, 300)
    adj = COOMatrix.from_numpy(r, c, np.abs(v), shape=(n, n), pad_to=64)
    s = gcn_norm(adj)
    mesh = make_mesh(4)
    s_sh = shard_csr(s, mesh, balance=balance)

    h = jnp.asarray(rng.randn(n, 12), jnp.float32)
    labels = jnp.asarray(rng.randint(0, 4, n), jnp.int32)
    mask = jnp.asarray(rng.rand(n) < 0.5)
    params = gcn_init(jax.random.PRNGKey(2), (12, 4))
    ev0 = s.vals

    p1, ev1, loss1 = jax.jit(
        lambda p, ev: gcn_train_step_edges(s, p, ev, h, labels, mask)
    )(params, ev0)
    p2, ev2, loss2 = jax.jit(
        lambda p, ev: gcn_train_step_edges(
            s, p, ev, h, labels, mask,
            spmm=lambda m, z: spmm_csr_sharded(
                s_sh.with_vals(m.vals), z, mesh
            ),
        )
    )(params, ev0)

    np.testing.assert_allclose(float(loss2), float(loss1), rtol=1e-5)
    np.testing.assert_allclose(
        np.asarray(ev2), np.asarray(ev1), rtol=1e-4, atol=1e-6
    )
    for (w1, b1), (w2, b2) in zip(p1, p2):
        np.testing.assert_allclose(
            np.asarray(w2), np.asarray(w1), rtol=1e-4, atol=1e-5
        )
    # The step actually moved the edge values.
    assert float(jnp.abs(ev1[: s.nnz] - ev0[: s.nnz]).max()) > 0


def test_cg_over_sharded_spmv():
    """Data-parallel CG: the solver loop composed with the sharded SpMV.

    Every CG step runs two dot-product all-reduces plus the row-block
    SpMV's all-gather — the full distributed-solve composition — and
    must match the dense solve.
    """
    from smvp_toolkit_tpu.models import conjugate_gradient

    import jax.numpy as jnp

    rng = np.random.RandomState(30)
    n = 48
    a = np.zeros((n, n))
    for _ in range(4 * n):
        i, j = rng.randint(0, n, 2)
        w = rng.rand()
        a[i, j] += w
        a[j, i] += w
    a += np.diag(np.abs(a).sum(axis=1) + 1.0)
    r, c = np.nonzero(a)
    coo = COOMatrix.from_numpy(
        r.astype(np.int32), c.astype(np.int32), a[r, c], shape=(n, n),
        pad_to=64,
    )
    csr = csr_encode(coo)
    mesh = make_mesh(8)
    sharded = shard_csr(csr, mesh)

    b = jnp.asarray(rng.randn(n), jnp.float32)
    x, res = conjugate_gradient(
        sharded, b, num_iters=80,
        spmv=lambda m, xx: spmv_csr_sharded(m, xx, mesh),
    )
    x_ref = np.linalg.solve(a, np.asarray(b, np.float64))
    np.testing.assert_allclose(np.asarray(x), x_ref, rtol=1e-3, atol=1e-4)


def test_nnz_balanced_sharding_powerlaw():
    """balance='nnz' splits a skewed matrix evenly and stays correct."""
    from smvp_toolkit_tpu.utils.synth import synth_powerlaw

    coo = synth_powerlaw(400, 6000, alpha=1.2, seed=7).pad(128)
    # Skew the ROW lengths (powerlaw skews columns): transpose the
    # pattern host-side.
    from smvp_toolkit_tpu.ops.algebra import transpose

    coo = transpose(coo)
    csr = csr_encode(coo)
    mesh = make_mesh(8)
    even = shard_csr(csr, mesh)
    bal = shard_csr(csr, mesh, balance="nnz")

    # Load balance: max block width shrinks vs the even-rows split.
    def widths(s):
        lr = np.asarray(s.local_rows)
        return (lr < s.rows_per_shard).sum(axis=1)

    assert widths(bal).max() <= widths(even).max()
    assert widths(bal).max() <= int(1.5 * csr.nnz / 8) + 8

    x = np.random.RandomState(8).randn(coo.shape[1]).astype(np.float32)
    y_ref = coo.to_dense() @ x.astype(np.float64)
    for sh in (even, bal):
        y = np.asarray(spmv_csr_sharded(sh, x, mesh))
        assert y.shape == (coo.shape[0],)
        np.testing.assert_allclose(y, y_ref, rtol=1e-4, atol=1e-4)


def test_nnz_balanced_spmm_and_empty_blocks():
    """nnz balancing with empty shards (few dense rows) stays ordered."""
    from smvp_toolkit_tpu.parallel import spmm_csr_sharded

    rng = np.random.RandomState(9)
    # 3 very dense rows + sparse tail -> some blocks get zero rows.
    r = np.concatenate([
        np.repeat(np.arange(3), 200),
        rng.randint(3, 64, size=100),
    ]).astype(np.int64)
    c = rng.randint(0, 64, size=len(r)).astype(np.int64)
    v = rng.randn(len(r))
    order = np.lexsort((c, r))
    coo = COOMatrix.from_numpy(
        r[order].astype(np.int32), c[order].astype(np.int32), v[order],
        shape=(64, 64), pad_to=64,
    )
    csr = csr_encode(coo)
    mesh = make_mesh(8)
    bal = shard_csr(csr, mesh, balance="nnz")
    X = rng.randn(64, 4).astype(np.float32)
    Y = np.asarray(spmm_csr_sharded(bal, X, mesh))
    np.testing.assert_allclose(
        Y, coo.to_dense() @ X.astype(np.float64), rtol=1e-4, atol=1e-4
    )


# ---------------------------------------------------------------------------
# 2-D (row x column) sharding — the TP structural cousin (SURVEY §2)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("grid", [(2, 4), (4, 2), (1, 8), (8, 1), (2, 2)])
def test_spmv_2d_sharding(grid):
    from smvp_toolkit_tpu.parallel import make_mesh_2d, shard_csr_2d, spmv_csr_2d

    coo = _coo(seed=31, nrows=101, ncols=87, nnz=900)  # uneven both ways
    csr = csr_encode(coo)
    mesh = make_mesh_2d(*grid)
    sharded = shard_csr_2d(csr, mesh)
    rng = np.random.RandomState(32)
    x = np.asarray(rng.randn(coo.shape[1]), dtype=np.float32)
    y = np.asarray(spmv_csr_2d(sharded, x, mesh))
    y_ref = coo.to_dense() @ x.astype(np.float64)
    assert y.shape == (coo.shape[0],)
    np.testing.assert_allclose(y, y_ref, rtol=1e-4, atol=1e-4)


def test_spmv_2d_matches_1d_rowblock():
    """C=1 must agree with the 1-D row-block path bit-for-bit-ish."""
    from smvp_toolkit_tpu.parallel import make_mesh_2d, shard_csr_2d, spmv_csr_2d

    coo = _coo(seed=33)
    csr = csr_encode(coo)
    mesh1 = make_mesh(4)
    mesh2 = make_mesh_2d(4, 1)
    x = np.ones(coo.shape[1], dtype=np.float32)
    y1 = np.asarray(spmv_csr_sharded(shard_csr(csr, mesh1), x, mesh1))
    y2 = np.asarray(spmv_csr_2d(shard_csr_2d(csr, mesh2), x, mesh2))
    np.testing.assert_allclose(y2, y1, rtol=1e-6, atol=1e-6)


def test_spmv_2d_sample_matrix():
    from smvp_toolkit_tpu.parallel import make_mesh_2d, shard_csr_2d, spmv_csr_2d

    coo = read_mtx(os.path.join(SAMPLE_DIR, "curtis54.mtx")).pad(128)
    csr = csr_encode(coo)
    mesh = make_mesh_2d(2, 4)
    y = np.asarray(spmv_csr_2d(shard_csr_2d(csr, mesh),
                               np.ones(54, dtype=np.float32), mesh))
    np.testing.assert_allclose(y.sum(), 291.0, rtol=1e-6)


@pytest.mark.parametrize("grid", [(2, 4), (4, 2)])
def test_spmm_2d_sharding(grid):
    from smvp_toolkit_tpu.parallel import make_mesh_2d, shard_csr_2d, spmm_csr_2d

    coo = _coo(seed=34, nrows=77, ncols=65, nnz=600)
    csr = csr_encode(coo)
    mesh = make_mesh_2d(*grid)
    sharded = shard_csr_2d(csr, mesh)
    rng = np.random.RandomState(35)
    X = np.asarray(rng.randn(coo.shape[1], 8), dtype=np.float32)
    Y = np.asarray(spmm_csr_2d(sharded, X, mesh))
    Y_ref = coo.to_dense() @ X.astype(np.float64)
    assert Y.shape == (coo.shape[0], 8)
    np.testing.assert_allclose(Y, Y_ref, rtol=1e-4, atol=1e-4)


def test_pcg_ic0_over_sharded_spmv():
    """Fully-distributed preconditioned CG: the A-multiplies AND the
    IC(0) trisolve sweeps all run as row-block sharded SpMVs.

    The preconditioner factories take any ``spmv(matrix, x)``; handing
    them the shard_map kernel makes every M⁻¹ apply ride the same
    all-gather as the solver — the complete data-parallel
    preconditioned-solve composition. Must match the dense solve and
    converge faster than plain distributed CG.
    """
    import jax.numpy as jnp

    from smvp_toolkit_tpu.models import (
        conjugate_gradient,
        ic0_preconditioner,
        pcg_precond,
    )
    from smvp_toolkit_tpu.ops.ilu import ic0

    nx = 8
    n = nx * nx
    a = np.zeros((n, n))
    for i in range(nx):
        for j in range(nx):
            k = i * nx + j
            a[k, k] = 4.0
            if i > 0:
                a[k, k - nx] = a[k - nx, k] = -1.0
            if j > 0:
                a[k, k - 1] = a[k - 1, k] = -1.0
    r, c = np.nonzero(a)
    coo = COOMatrix.from_numpy(
        r.astype(np.int32), c.astype(np.int32), a[r, c], shape=(n, n),
        pad_to=64,
    )
    csr = csr_encode(coo)
    mesh = make_mesh(8)
    s_a = shard_csr(csr, mesh)

    factors = ic0(csr)
    s_l = shard_csr(factors.strict, mesh)
    s_lt = shard_csr(factors.strict_t, mesh)

    # Per-factor sharded operators via op_builder: the factory calls it
    # once per factor; each closure rides shard_map's collective.
    built = {id(factors.strict): s_l, id(factors.strict_t): s_lt}
    m = ic0_preconditioner(
        factors, sweeps=4,
        op_builder=lambda f: (
            lambda z, _s=built[id(f)]: spmv_csr_sharded(_s, z, mesh)
        ),
    )

    rng = np.random.RandomState(31)
    b = jnp.asarray(rng.randn(n), jnp.float32)
    iters = 16
    x, res_p = pcg_precond(
        s_a, b, m, num_iters=iters,
        spmv=lambda mm, xx: spmv_csr_sharded(mm, xx, mesh),
    )
    _, res_cg = conjugate_gradient(
        s_a, b, num_iters=iters,
        spmv=lambda mm, xx: spmv_csr_sharded(mm, xx, mesh),
    )
    assert float(res_p[-1]) < 0.5 * float(res_cg[-1])
    x_ref = np.linalg.solve(a, np.asarray(b, np.float64))
    np.testing.assert_allclose(np.asarray(x), x_ref, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("k", [3, 8, 11])
def test_sharded_spmm_matches_columns(k):
    """spmm_csr_sharded matches the dense reference and k per-column
    sharded SpMVs."""
    import jax.numpy as jnp

    from smvp_toolkit_tpu.parallel import spmm_csr_sharded

    coo = _coo(seed=21, nrows=260, ncols=200, nnz=1500)
    mesh = make_mesh(4)
    sh = shard_csr(csr_encode(coo), mesh)
    rng = np.random.RandomState(6)
    X = np.asarray(rng.randn(coo.shape[1], k), dtype=np.float32)
    Y = np.asarray(spmm_csr_sharded(sh, jnp.asarray(X), mesh))
    Y_ref = coo.to_dense() @ X.astype(np.float64)
    np.testing.assert_allclose(Y, Y_ref, rtol=1e-4, atol=1e-5)
    cols = np.stack(
        [np.asarray(spmv_csr_sharded(sh, X[:, j], mesh)) for j in range(k)],
        axis=1,
    )
    np.testing.assert_allclose(Y, cols, rtol=1e-5, atol=1e-6)


def test_sharded_spmm_2d_matches_1d():
    """The 2x2-mesh SpMM and the 1-D row-block SpMM agree."""
    import jax.numpy as jnp

    from smvp_toolkit_tpu.parallel import (
        make_mesh_2d,
        shard_csr_2d,
        spmm_csr_2d,
        spmm_csr_sharded,
    )

    coo = _coo(seed=22, nrows=130, ncols=130, nnz=700)
    csr = csr_encode(coo)
    rng = np.random.RandomState(7)
    X = jnp.asarray(rng.randn(coo.shape[1], 4).astype(np.float32))
    mesh = make_mesh(4)
    mesh2 = make_mesh_2d(2, 2)
    Y1 = np.asarray(spmm_csr_sharded(shard_csr(csr, mesh), X, mesh))
    Y2 = np.asarray(spmm_csr_2d(shard_csr_2d(csr, mesh2), X, mesh2))
    np.testing.assert_allclose(Y1, Y2, rtol=1e-5, atol=1e-6)


def test_sharded_spmm_transpose_by_autodiff():
    """The cotangent of the sharded SpMM is Aᵀ·G (scatter-add through
    shard_map), matching the dense oracle."""
    import jax.numpy as jnp

    from smvp_toolkit_tpu.parallel import spmm_csr_sharded

    coo = _coo(seed=23, nrows=260, ncols=200, nnz=1500)
    mesh = make_mesh(4)
    sh = shard_csr(csr_encode(coo), mesh)
    rng = np.random.RandomState(8)
    X = jnp.asarray(rng.randn(coo.shape[1], 5).astype(np.float32))
    G = np.asarray(rng.randn(coo.shape[0], 5), dtype=np.float32)
    _, vjp = jax.vjp(lambda xx: spmm_csr_sharded(sh, xx, mesh), X)
    (Z,) = vjp(jnp.asarray(G))
    Z_ref = coo.to_dense().T @ G.astype(np.float64)
    np.testing.assert_allclose(np.asarray(Z), Z_ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("balance", ["rows", "nnz"])
def test_sharded_spmm_grad_wrt_values(balance):
    """d/dvals through the sharded SpMM (with_vals reshards the live
    values) equals the single-device gradient."""
    import jax.numpy as jnp

    from smvp_toolkit_tpu.ops import spmm_csr
    from smvp_toolkit_tpu.parallel import spmm_csr_sharded

    coo = _coo(seed=24, nrows=140, ncols=140, nnz=900)
    csr = csr_encode(coo)
    mesh = make_mesh(4)
    sh = shard_csr(csr, mesh, balance=balance)
    rng = np.random.RandomState(9)
    X = jnp.asarray(rng.randn(coo.shape[1], 3).astype(np.float32))
    G = jnp.asarray(rng.randn(coo.shape[0], 3).astype(np.float32))

    def loss_dist(ev):
        return jnp.vdot(G, spmm_csr_sharded(sh.with_vals(ev), X, mesh))

    def loss_single(ev):
        import dataclasses

        return jnp.vdot(G, spmm_csr(dataclasses.replace(csr, vals=ev), X))

    g_dist = np.asarray(jax.grad(loss_dist)(csr.vals))
    g_single = np.asarray(jax.grad(loss_single)(csr.vals))
    np.testing.assert_allclose(g_dist, g_single, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("alg", ["CSR", "TJDS"])
def test_shard_and_bench_matches_spmv(alg):
    """The CLI's sharded benchmark helper returns the single-device y."""
    import jax.numpy as jnp

    from smvp_toolkit_tpu.ops import spmv_csr, spmv_tjds
    from smvp_toolkit_tpu.parallel import shard_and_bench

    coo = read_mtx(os.path.join(SAMPLE_DIR, "memplus.mtx")).pad(128)
    enc = csr_encode(coo) if alg == "CSR" else tjds_encode(coo)
    spmv = spmv_csr if alg == "CSR" else spmv_tjds
    x = jnp.asarray(
        np.random.RandomState(5).randn(coo.shape[1]).astype(np.float32)
    )
    stats, y = shard_and_bench(alg, enc, x, 4, iterations=3)
    assert stats.iterations == 3 and stats.avg_ms > 0
    np.testing.assert_allclose(y, np.asarray(spmv(enc, x)), rtol=1e-5,
                               atol=1e-5)
