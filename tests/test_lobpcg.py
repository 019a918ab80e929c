"""LOBPCG block eigensolver: accuracy vs dense eigendecomposition, the
AMG-preconditioned acceleration, and the fused-SpMM seam."""

import numpy as np
import pytest

import jax.numpy as jnp

from smvp_toolkit_tpu.formats.coo import COOMatrix
from smvp_toolkit_tpu.formats.csr import csr_encode
from smvp_toolkit_tpu.models import amg_preconditioner, lobpcg


from conftest import poisson2d


def _poisson(nx):
    dense = poisson2d(nx)
    r, c = np.nonzero(dense)
    coo = COOMatrix.from_numpy(
        r.astype(np.int32), c.astype(np.int32),
        dense[r, c].astype(np.float32), shape=dense.shape, pad_to=128,
    )
    return csr_encode(coo), dense


def test_lobpcg_smallest_eigenpairs():
    csr, dense = _poisson(20)
    true = np.linalg.eigvalsh(dense)
    k = 4
    X0 = jnp.asarray(
        np.random.RandomState(0).randn(dense.shape[0], k).astype(np.float32)
    )
    theta, X, res = lobpcg(csr, X0, num_iters=60)
    np.testing.assert_allclose(np.asarray(theta), true[:k], rtol=5e-3,
                               atol=1e-4)
    # eigenvector residuals ||A x − θ x|| shrink below the start
    assert np.asarray(res)[-1].max() < 0.1 * np.asarray(res)[0].max()
    # Ritz block is orthonormal
    g = np.asarray(X).T @ np.asarray(X)
    np.testing.assert_allclose(g, np.eye(k), atol=1e-4)


def test_lobpcg_amg_preconditioned():
    """AMG preconditioning reaches far tighter residuals at equal
    iteration counts — the grid-independence story for eigenproblems."""
    csr, dense = _poisson(24)
    true = np.linalg.eigvalsh(dense)
    k = 4
    X0 = jnp.asarray(
        np.random.RandomState(1).randn(dense.shape[0], k).astype(np.float32)
    )
    theta_p, _, res_p = lobpcg(
        csr, X0, num_iters=40, m=amg_preconditioner(csr)
    )
    _, _, res = lobpcg(csr, X0, num_iters=40)
    assert np.asarray(res_p)[-1].max() < 0.1 * np.asarray(res)[-1].max()
    np.testing.assert_allclose(np.asarray(theta_p), true[:k], rtol=1e-3,
                               atol=1e-5)


def test_lobpcg_largest():
    csr, dense = _poisson(16)
    true = np.linalg.eigvalsh(dense)
    k = 3
    X0 = jnp.asarray(
        np.random.RandomState(2).randn(dense.shape[0], k).astype(np.float32)
    )
    theta, _, _ = lobpcg(csr, X0, num_iters=60, largest=True)
    np.testing.assert_allclose(np.asarray(theta), true[-k:][::-1],
                               rtol=1e-3)


def test_lobpcg_spmm_seam():
    """Another SpMM (the TJDS one) drops into the spmm= seam with
    matching Ritz values."""
    from smvp_toolkit_tpu.formats.csr import csr_decode
    from smvp_toolkit_tpu.formats.tjds import tjds_encode
    from smvp_toolkit_tpu.ops import spmm_tjds

    csr, dense = _poisson(12)
    k = 3
    X0 = jnp.asarray(
        np.random.RandomState(3).randn(dense.shape[0], k).astype(np.float32)
    )
    tj = tjds_encode(csr_decode(csr))
    theta_fused, _, _ = lobpcg(
        csr, X0, num_iters=30, spmm=lambda m, X: spmm_tjds(tj, X)
    )
    theta_xla, _, _ = lobpcg(csr, X0, num_iters=30)
    np.testing.assert_allclose(np.asarray(theta_fused),
                               np.asarray(theta_xla), rtol=1e-4,
                               atol=1e-5)


def test_eigs_cli_flag(tmp_path):
    """--eigs K[:ITERS]: AMG-preconditioned LOBPCG from the CLI with a
    machine-readable record; usage errors are rc 2."""
    import json
    import scipy.sparse as sp

    from smvp_toolkit_tpu.cli import main as cli_main
    from smvp_toolkit_tpu.io.mtx import write_mtx

    nx = 16
    n = nx * nx
    eye = sp.eye(nx)
    t = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], (nx, nx))
    a = (sp.kron(eye, t) + sp.kron(t, eye)).tocoo()
    path = tmp_path / "poisson.mtx"
    write_mtx(str(path), a.row.astype(np.int32), a.col.astype(np.int32),
              a.data, (n, n))
    out = tmp_path / "m.jsonl"
    rc = cli_main(["-c", "-n", "1", "--no-report", "--eigs", "3:40",
                   "--json-out", str(out), str(path)])
    assert rc == 0
    rec = [json.loads(l) for l in out.read_text().splitlines()][-1]
    assert rec["alg"] == "EIGS-LOBPCG" and rec["preconditioner"] == "amg"
    true = np.linalg.eigvalsh(np.asarray(a.todense()))[:3]
    np.testing.assert_allclose(rec["eigenvalues"], true, rtol=1e-3,
                               atol=1e-4)
    assert max(rec["residual_norms"]) < 1e-3

    for bad in ("0", "3:0", "x", "3:2:1"):
        assert cli_main(["-c", "-n", "1", "--no-report", "--eigs", bad,
                         str(path)]) == 2
    assert cli_main(["-t", "-n", "1", "--no-report", "--eigs", "2",
                     str(path)]) == 2


def test_lobpcg_distributed_composition():
    """Distributed eigensolving by injection alone: the A-multiplies
    ride the row-block sharded SpMM and the preconditioner is the
    distributed AMG V-cycle — Ritz values match the single-chip run."""
    import jax

    if len(jax.devices()) < 4:
        pytest.skip("needs >= 4 (virtual) devices")

    from smvp_toolkit_tpu.models import amg_preconditioner, amg_setup
    from smvp_toolkit_tpu.parallel import (
        make_mesh,
        shard_csr,
        spmm_csr_sharded,
        spmv_csr_sharded,
    )

    csr, dense = _poisson(16)
    n = dense.shape[0]
    mesh = make_mesh(4)
    sh = shard_csr(csr, mesh)
    levels = amg_setup(csr, coarse_size=32)

    def builder(c):
        s = shard_csr(c, mesh)
        return lambda z: spmv_csr_sharded(s, z, mesh)

    m_dist = amg_preconditioner(csr, levels=levels, op_builder=builder)
    k = 3
    X0 = jnp.asarray(
        np.random.RandomState(4).randn(n, k).astype(np.float32)
    )
    theta_d, _, _ = lobpcg(
        csr, X0, num_iters=40, m=m_dist,
        spmm=lambda _m, Z: spmm_csr_sharded(sh, Z, mesh),
    )
    theta_s, _, _ = lobpcg(
        csr, X0, num_iters=40, m=amg_preconditioner(csr, levels=levels)
    )
    np.testing.assert_allclose(np.asarray(theta_d), np.asarray(theta_s),
                               rtol=1e-3, atol=1e-5)
    true = np.linalg.eigvalsh(dense)[:k]
    np.testing.assert_allclose(np.asarray(theta_d), true, rtol=1e-3,
                               atol=1e-4)
