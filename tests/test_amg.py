"""Smoothed-aggregation AMG: hierarchy structure, CG safety, and the
headline property — iteration counts independent of problem size."""

import numpy as np
import pytest

import jax.numpy as jnp

from smvp_toolkit_tpu.formats.coo import COOMatrix
from smvp_toolkit_tpu.formats.csr import csr_encode
from smvp_toolkit_tpu.models import (
    amg_preconditioner,
    amg_setup,
    conjugate_gradient,
    pcg_precond,
)


from conftest import poisson2d as _poisson2d


def _encode(a, pad_to=128):
    r, c = np.nonzero(a)
    return csr_encode(COOMatrix.from_numpy(
        r.astype(np.int32), c.astype(np.int32),
        a[r, c].astype(np.float32), shape=a.shape, pad_to=pad_to,
    ))


def _iters_to(res, b, tol):
    rn = np.asarray(res)
    tgt = tol * np.linalg.norm(np.asarray(b))
    hit = np.nonzero(rn <= tgt)[0]
    return int(hit[0]) + 1 if hit.size else len(rn)


def test_amg_hierarchy_structure():
    """Levels coarsen strictly; every non-coarsest level has operators;
    the coarsest carries the dense inverse."""
    csr = _encode(_poisson2d(24))
    levels = amg_setup(csr, coarse_size=64)
    sizes = [lv.n for lv in levels]
    assert sizes[0] == 24 * 24
    assert all(a > b for a, b in zip(sizes, sizes[1:]))
    assert sizes[-1] <= 64
    for lv in levels[:-1]:
        assert lv.a_csr is not None and lv.p_csr is not None
        assert lv.pt_csr is not None and lv.coarse_inv is None
        assert 0.0 < lv.omega < 2.0
    assert levels[-1].coarse_inv is not None
    assert levels[-1].coarse_inv.shape == (sizes[-1], sizes[-1])


def test_amg_grid_independent_iterations():
    """The AMG headline: PCG iteration counts stay O(10) as the grid
    grows, while plain CG grows with the grid."""
    tol = 1e-6
    amg_counts, cg_counts = [], []
    for nx in (16, 32, 48):
        a = _poisson2d(nx)
        csr = _encode(a)
        m = amg_preconditioner(csr)
        rng = np.random.RandomState(0)
        b = jnp.asarray(rng.randn(a.shape[0]).astype(np.float32))
        _, res_cg = conjugate_gradient(csr, b, num_iters=400, tol=tol)
        x, res = pcg_precond(csr, b, m, num_iters=60, tol=tol)
        cg_counts.append(_iters_to(res_cg, b, tol))
        amg_counts.append(_iters_to(res, b, tol))
        relres = np.linalg.norm(
            a @ np.asarray(x, np.float64) - np.asarray(b)
        ) / np.linalg.norm(np.asarray(b))
        assert relres < 1e-5
    assert max(amg_counts) <= 15
    assert cg_counts[-1] > 3 * amg_counts[-1]
    # grid independence: count must not grow with the grid (±2 noise)
    assert amg_counts[-1] <= amg_counts[0] + 2


def test_amg_apply_is_spd():
    """The symmetric V(ν,ν) cycle is a symmetric PD operator (CG-safe)."""
    a = _poisson2d(8)
    n = a.shape[0]
    csr = _encode(a, pad_to=64)
    m_apply = amg_preconditioner(csr, sweeps=2)
    m = np.stack(
        [np.asarray(m_apply(jnp.eye(n, dtype=jnp.float32)[j]))
         for j in range(n)],
        axis=1,
    ).astype(np.float64)
    np.testing.assert_allclose(m, m.T, rtol=1e-4, atol=1e-5)
    assert np.linalg.eigvalsh((m + m.T) / 2).min() > 0


def test_amg_tiny_matrix_direct():
    """A matrix at/below coarse_size becomes a single dense-solve level:
    the apply is the (ridged) exact inverse."""
    rng = np.random.RandomState(3)
    n = 20
    a = rng.randn(n, n)
    a = a @ a.T + n * np.eye(n)
    csr = _encode(a, pad_to=32)
    levels = amg_setup(csr, coarse_size=128)
    assert len(levels) == 1 and levels[0].coarse_inv is not None
    m = amg_preconditioner(csr, levels=levels)
    r = rng.randn(n).astype(np.float32)
    z = np.asarray(m(jnp.asarray(r)), np.float64)
    np.testing.assert_allclose(z, np.linalg.solve(a, r), rtol=1e-4,
                               atol=1e-4)


def _cusparse_op(csr):
    from functools import partial

    from smvp_toolkit_tpu.ops import spmv_csr_cusparse

    return partial(spmv_csr_cusparse, csr)


def test_amg_cusparse_op_builder():
    """Every level operator built through op_builder (here the cuSPARSE
    route) matches the XLA-path apply."""

    a = _poisson2d(12)
    csr = _encode(a)
    levels = amg_setup(csr)
    rng = np.random.RandomState(4)
    r = jnp.asarray(rng.randn(a.shape[0]).astype(np.float32))
    z_xla = np.asarray(amg_preconditioner(csr, levels=levels)(r))
    z_lib = np.asarray(
        amg_preconditioner(csr, levels=levels, op_builder=_cusparse_op)(r)
    )
    np.testing.assert_allclose(z_lib, z_xla, rtol=1e-4, atol=1e-5)


def test_amg_validation():
    rect = COOMatrix.from_numpy(
        np.array([0], np.int32), np.array([1], np.int32),
        np.array([1.0], np.float32), shape=(2, 3), pad_to=8,
    )
    with pytest.raises(ValueError, match="square"):
        amg_setup(csr_encode(rect))
    csr = _encode(_poisson2d(6), pad_to=32)
    with pytest.raises(ValueError, match="sweeps"):
        amg_preconditioner(csr, sweeps=0)


def test_amg_cli_solve(tmp_path):
    """--solve pcg-amg end to end, early-stopped iteration count."""
    import json
    import os

    from smvp_toolkit_tpu.cli import main as cli_main
    from smvp_toolkit_tpu.io.mtx import write_mtx

    a = _poisson2d(16)
    r, c = np.nonzero(a)
    path = tmp_path / "poisson.mtx"
    write_mtx(str(path), r.astype(np.int32), c.astype(np.int32),
              a[r, c], a.shape)
    out = tmp_path / "m.jsonl"
    rc = cli_main(["-c", "-n", "1", "--no-report",
                   "--solve", "pcg-amg:60:1e-6",
                   "--json-out", str(out), str(path)])
    assert rc == 0
    recs = [json.loads(ln) for ln in out.read_text().splitlines()]
    solve = [x for x in recs if x["alg"] == "SOLVE-PCG-AMG"]
    assert len(solve) == 1
    assert solve[0]["relative_residual"] < 1e-5
    assert solve[0]["iterations"] <= 15


def test_pcg_amg_over_sharded_spmv():
    """Fully-distributed AMG-preconditioned CG: every level's A, P and
    Pᵀ apply as row-block sharded SpMVs through the op_builder seam,
    and the V-cycle result matches the single-chip apply exactly."""
    import jax

    if len(jax.devices()) < 4:
        pytest.skip("needs >= 4 (virtual) devices")

    from smvp_toolkit_tpu.parallel import (
        make_mesh,
        shard_csr,
        spmv_csr_sharded,
    )

    a = _poisson2d(16)
    n = a.shape[0]
    csr = _encode(a)
    mesh = make_mesh(4)
    levels = amg_setup(csr, coarse_size=32)

    def builder(c):
        s = shard_csr(c, mesh)
        return lambda z: spmv_csr_sharded(s, z, mesh)

    m_dist = amg_preconditioner(csr, levels=levels, op_builder=builder)
    m_local = amg_preconditioner(csr, levels=levels)
    rng = np.random.RandomState(5)
    r = jnp.asarray(rng.randn(n).astype(np.float32))
    np.testing.assert_allclose(
        np.asarray(m_dist(r)), np.asarray(m_local(r)), rtol=1e-5,
        atol=1e-6,
    )

    s_a = shard_csr(csr, mesh)
    b = jnp.asarray(rng.randn(n).astype(np.float32))
    x, res = pcg_precond(
        s_a, b, m_dist, num_iters=20, tol=1e-6,
        spmv=lambda mm, xx: spmv_csr_sharded(mm, xx, mesh),
    )
    relres = np.linalg.norm(
        a @ np.asarray(x, np.float64) - np.asarray(b)
    ) / np.linalg.norm(np.asarray(b))
    assert relres < 1e-5
    assert _iters_to(res, b, 1e-6) <= 15


def test_amg_review_guards():
    """Round-3 review fixes: stalled aggregation raises (no huge dense
    inverse), extra cycles on a coarse-only hierarchy don't crash, and
    a prebuilt hierarchy rejects setup keywords / mismatched matrices."""
    # Strongly diagonally dominant: no strong connections -> the
    # coarsening stalls immediately; with n above the dense cap this
    # must be a clear error, not an n^2 densify.
    import smvp_toolkit_tpu.models.amg as amg_mod

    rng = np.random.RandomState(6)
    n = 300
    a = np.eye(n) * 100.0
    for _ in range(3 * n):
        i, j = rng.randint(0, n, 2)
        if i != j:
            a[i, j] = a[j, i] = 1e-4
    csr = _encode(a)
    old = amg_mod._DENSE_LIMIT
    amg_mod._DENSE_LIMIT = 128
    try:
        with pytest.raises(ValueError, match="stalled"):
            amg_setup(csr, coarse_size=64)
    finally:
        amg_mod._DENSE_LIMIT = old
    # ...while within the dense cap the stall degrades to direct solve.
    levels = amg_setup(csr, coarse_size=64)
    assert levels[-1].coarse_inv is not None

    # cycles >= 2 on a coarse-only hierarchy: exact solve, no crash.
    small = _poisson2d(5)
    csr_s = _encode(small, pad_to=32)
    m = amg_preconditioner(csr_s, cycles=3)
    r = rng.randn(small.shape[0]).astype(np.float32)
    np.testing.assert_allclose(
        np.asarray(m(jnp.asarray(r)), np.float64),
        np.linalg.solve(small, r), rtol=1e-4, atol=1e-4,
    )

    # prebuilt levels: setup keywords and mismatched shapes are errors.
    lv = amg_setup(csr_s)
    with pytest.raises(ValueError, match="prebuilt"):
        amg_preconditioner(csr_s, levels=lv, theta=0.25)
    other = _encode(_poisson2d(7), pad_to=32)
    with pytest.raises(ValueError, match="n="):
        amg_preconditioner(other, levels=lv)


def test_amg_chebyshev_smoother():
    """The Chebyshev polynomial smoother: still SPD (CG-safe), still
    grid-robust counts, and rejected names error."""
    a = _poisson2d(8)
    n = a.shape[0]
    csr = _encode(a, pad_to=64)
    levels = amg_setup(csr, coarse_size=16)
    m_apply = amg_preconditioner(
        csr, levels=levels, sweeps=3, smoother="chebyshev"
    )
    m = np.stack(
        [np.asarray(m_apply(jnp.eye(n, dtype=jnp.float32)[j]))
         for j in range(n)],
        axis=1,
    ).astype(np.float64)
    np.testing.assert_allclose(m, m.T, rtol=1e-4, atol=1e-5)
    assert np.linalg.eigvalsh((m + m.T) / 2).min() > 0

    big = _poisson2d(32)
    csr_b = _encode(big)
    mb = amg_preconditioner(csr_b, sweeps=3, smoother="chebyshev")
    rng = np.random.RandomState(7)
    b = jnp.asarray(rng.randn(big.shape[0]).astype(np.float32))
    x, res = pcg_precond(csr_b, b, mb, num_iters=40, tol=1e-6)
    assert _iters_to(res, b, 1e-6) <= 15

    with pytest.raises(ValueError, match="smoother"):
        amg_preconditioner(csr, smoother="gauss-seidel")


def test_bicgstab_amg_nonsymmetric(tmp_path):
    """--solve bicgstab-amg: AMG on the symmetric part right-
    preconditions a convection-diffusion solve better than plain
    BiCGSTAB at equal iterations."""
    import json

    from smvp_toolkit_tpu.cli import main as cli_main
    from smvp_toolkit_tpu.io.mtx import write_mtx

    a = _poisson2d(16).copy()
    rng = np.random.RandomState(9)
    n = a.shape[0]
    for kk in range(n - 1):
        if rng.rand() < 0.7 and a[kk, kk + 1] != 0:
            a[kk, kk + 1] -= 0.35  # upwind convection
    r, c = np.nonzero(a)
    path = tmp_path / "conv.mtx"
    write_mtx(str(path), r.astype(np.int32), c.astype(np.int32),
              a[r, c], a.shape)

    def run(method):
        out = tmp_path / f"{method}.jsonl"
        rc = cli_main(["-c", "-n", "1", "--no-report",
                       "--solve", f"{method}:80",
                       "--json-out", str(out), str(path)])
        assert rc == 0
        rec = [json.loads(ln) for ln in out.read_text().splitlines()][-1]
        return rec["relative_residual"]

    assert run("bicgstab-amg") < 0.1 * run("bicgstab")


def test_amg_block_apply_matches_per_column():
    """The k-wide V-cycle equals k vector V-cycles exactly (same
    program, broadcast diagonals; matmat level ops on the default path,
    per-column applies for a builder without one)."""

    a = _poisson2d(12)
    csr = _encode(a)
    levels = amg_setup(csr)
    rng = np.random.RandomState(8)
    R = jnp.asarray(rng.randn(a.shape[0], 5).astype(np.float32))
    for builder in (None, _cusparse_op):
        m = amg_preconditioner(csr, levels=levels, op_builder=builder)
        Z_block = np.asarray(m(R))
        Z_cols = np.stack(
            [np.asarray(m(R[:, j])) for j in range(5)], axis=1
        )
        np.testing.assert_allclose(Z_block, Z_cols, rtol=1e-5, atol=1e-6)


def test_native_aggregation_matches_python():
    """native/amg.cpp's aggregation pass is identical to the numpy
    loop (same seeds, same attachment order, same singleton ids)."""
    import smvp_toolkit_tpu.models.amg as amg_mod

    if amg_mod._amg_lib() is None:
        pytest.skip("libamg.so not built")
    rng = np.random.RandomState(11)
    for n, nnz in [(200, 1200), (500, 4000), (64, 100)]:
        r = rng.randint(0, n, nnz)
        c = rng.randint(0, n, nnz)
        keep = r != c
        import scipy.sparse as sp

        s = sp.csr_matrix(
            (np.ones(keep.sum() * 2),
             (np.concatenate([r[keep], c[keep]]),
              np.concatenate([c[keep], r[keep]]))),
            shape=(n, n),
        )
        agg_n, nc_n = amg_mod._aggregate(s)
        monk = "SMVP_NATIVE_AMG"
        import os

        os.environ[monk] = "0"
        try:
            agg_p, nc_p = amg_mod._aggregate(s)
        finally:
            del os.environ[monk]
        assert nc_n == nc_p
        np.testing.assert_array_equal(agg_n, agg_p)


def test_bicgstab_amg_symmetric_storage(tmp_path):
    """Symmetric-STORAGE inputs (one stored triangle) must build the
    hierarchy on the true (A+Aᵀ)/2, not on a half-triangle artifact."""
    import json

    from smvp_toolkit_tpu.cli import main as cli_main
    from smvp_toolkit_tpu.io.mtx import write_mtx

    a = _poisson2d(12)
    r, c = np.nonzero(np.tril(a))  # store the lower triangle only
    path = tmp_path / "spd_sym.mtx"
    write_mtx(str(path), r.astype(np.int32), c.astype(np.int32),
              a[r, c], a.shape, field="real", symmetry="symmetric")
    out = tmp_path / "m.jsonl"
    rc = cli_main(["-c", "-n", "1", "--no-report", "--expand-symmetry",
                   "--solve", "bicgstab-amg:60:1e-6",
                   "--json-out", str(out), str(path)])
    assert rc == 0
    rec = [json.loads(ln) for ln in out.read_text().splitlines()][-1]
    assert rec["relative_residual"] < 1e-4


def test_amg_hierarchy_checkpoint(tmp_path):
    """save_hierarchy/load_hierarchy round-trip: the reloaded levels
    produce bit-identical V-cycle applies (setup is the expensive half
    — encode-once deployments reload it)."""
    from smvp_toolkit_tpu.utils.checkpoint import (
        load_hierarchy,
        save_hierarchy,
    )

    a = _poisson2d(16)
    csr = _encode(a)
    levels = amg_setup(csr, coarse_size=32)
    path = tmp_path / "hier.npz"
    save_hierarchy(str(path), levels)
    reloaded = load_hierarchy(str(path))
    assert [lv.n for lv in reloaded] == [lv.n for lv in levels]

    rng = np.random.RandomState(12)
    r = jnp.asarray(rng.randn(a.shape[0]).astype(np.float32))
    z0 = np.asarray(amg_preconditioner(csr, levels=levels)(r))
    z1 = np.asarray(amg_preconditioner(None, levels=reloaded)(r))
    np.testing.assert_array_equal(z0, z1)


def test_block_pcg_with_amg():
    """Preconditioned block CG: AMG's k-wide V-cycle per iteration cuts
    the multi-RHS solve to grid-independent counts and matches the
    dense solve; unpreconditioned block CG needs far more steps."""
    import jax

    from smvp_toolkit_tpu.models import block_cg

    a = _poisson2d(24)
    n = a.shape[0]
    csr = _encode(a)
    m = amg_preconditioner(csr)
    rng = np.random.RandomState(13)
    B = jnp.asarray(rng.randn(n, 4).astype(np.float32))
    X, res = block_cg(csr, B, num_iters=15, m=m)
    jax.block_until_ready(X)
    X_ref = np.linalg.solve(a, np.asarray(B, np.float64))
    np.testing.assert_allclose(np.asarray(X), X_ref, rtol=1e-3,
                               atol=1e-3)
    _, res_plain = block_cg(csr, B, num_iters=15)
    assert np.asarray(res)[-1].max() < 0.05 * np.asarray(res_plain)[-1].max()


def test_gmres_right_preconditioned_cli(tmp_path):
    """gmres-ilu / gmres-amg: right-preconditioned restarted GMRES from
    the CLI converges on the convection-diffusion fixture where plain
    BiCGSTAB stalls."""
    import json

    from smvp_toolkit_tpu.cli import main as cli_main
    from smvp_toolkit_tpu.io.mtx import write_mtx

    a = _poisson2d(16).copy()
    rng = np.random.RandomState(9)
    n = a.shape[0]
    for kk in range(n - 1):
        if rng.rand() < 0.7 and a[kk, kk + 1] != 0:
            a[kk, kk + 1] -= 0.35
    r, c = np.nonzero(a)
    path = tmp_path / "conv.mtx"
    write_mtx(str(path), r.astype(np.int32), c.astype(np.int32),
              a[r, c], a.shape)

    for method in ("gmres-ilu", "gmres-amg"):
        out = tmp_path / f"{method}.jsonl"
        rc = cli_main(["-c", "-n", "1", "--no-report",
                       "--solve", f"{method}:80:1e-6",
                       "--json-out", str(out), str(path)])
        assert rc == 0
        rec = [json.loads(ln) for ln in out.read_text().splitlines()][-1]
        assert rec["relative_residual"] < 1e-4, method
