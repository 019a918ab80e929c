"""Solver-model tests: power iteration, PageRank, CG, Jacobi on CSR/TJDS."""

import numpy as np
import pytest

from smvp_toolkit_tpu.formats.coo import COOMatrix
from smvp_toolkit_tpu.formats.csr import csr_encode
from smvp_toolkit_tpu.formats.tjds import tjds_encode
from smvp_toolkit_tpu.models import (
    conjugate_gradient,
    jacobi,
    pagerank,
    power_iteration,
)
from smvp_toolkit_tpu.ops import spmv_tjds


def _spd_coo(n=24, seed=0):
    """Sparse symmetric positive-definite matrix (diagonally dominant)."""
    rng = np.random.RandomState(seed)
    a = np.zeros((n, n))
    for _ in range(3 * n):
        i, j = rng.randint(0, n, 2)
        w = rng.rand()
        a[i, j] += w
        a[j, i] += w
    a += np.diag(np.abs(a).sum(axis=1) + 1.0)
    r, c = np.nonzero(a)
    return (
        COOMatrix.from_numpy(
            r.astype(np.int32), c.astype(np.int32), a[r, c], shape=(n, n),
            pad_to=64,
        ),
        a,
    )


def test_power_iteration_dominant_eigenvalue():
    coo, a = _spd_coo()
    csr = csr_encode(coo)
    import jax.numpy as jnp

    x0 = jnp.ones((a.shape[0],), dtype=jnp.float32)
    lam, vec = power_iteration(csr, x0, num_iters=200)
    lam_ref = np.max(np.abs(np.linalg.eigvalsh(a)))
    np.testing.assert_allclose(float(lam), lam_ref, rtol=1e-3)
    # Eigenvector residual.
    v = np.asarray(vec, dtype=np.float64)
    np.testing.assert_allclose(a @ v, float(lam) * v, rtol=2e-2, atol=1e-3)


def test_conjugate_gradient_solves():
    coo, a = _spd_coo(seed=1)
    csr = csr_encode(coo)
    import jax.numpy as jnp

    rng = np.random.RandomState(2)
    b = jnp.asarray(rng.randn(a.shape[0]), dtype=jnp.float32)
    x, res = conjugate_gradient(csr, b, num_iters=100)
    x_ref = np.linalg.solve(a, np.asarray(b, dtype=np.float64))
    np.testing.assert_allclose(np.asarray(x), x_ref, rtol=1e-2, atol=1e-3)
    assert float(res[-1]) < 1e-2 * float(res[0])


def test_jacobi_converges():
    coo, a = _spd_coo(seed=3)
    csr = csr_encode(coo)
    import jax.numpy as jnp

    b = jnp.ones((a.shape[0],), dtype=jnp.float32)
    diag = jnp.asarray(np.diag(a), dtype=jnp.float32)
    x = jacobi(csr, b, diag, num_iters=300)
    x_ref = np.linalg.solve(a, np.ones(a.shape[0]))
    np.testing.assert_allclose(np.asarray(x), x_ref, rtol=1e-2, atol=1e-3)


def test_pagerank_stochastic():
    # Small column-stochastic link matrix.
    n = 10
    rng = np.random.RandomState(4)
    dense = (rng.rand(n, n) < 0.4).astype(np.float64)
    dense[np.diag_indices(n)] = 0
    colsum = dense.sum(axis=0)
    colsum[colsum == 0] = 1
    dense = dense / colsum
    r, c = np.nonzero(dense)
    coo = COOMatrix.from_numpy(
        r.astype(np.int32), c.astype(np.int32), dense[r, c], shape=(n, n),
        pad_to=64,
    )
    csr = csr_encode(coo)
    rank = np.asarray(pagerank(csr, num_iters=100))
    assert rank.shape == (n,)
    np.testing.assert_allclose(rank.sum(), 1.0, rtol=1e-5)
    assert (rank >= 0).all()


def test_solver_with_tjds_kernel():
    # Solvers accept any spmv implementation (format-agnostic).
    coo, a = _spd_coo(seed=5)
    tj = tjds_encode(coo)
    import jax.numpy as jnp

    b = jnp.ones((a.shape[0],), dtype=jnp.float32)
    x, res = conjugate_gradient(tj, b, num_iters=100, spmv=spmv_tjds)
    x_ref = np.linalg.solve(a, np.ones(a.shape[0]))
    np.testing.assert_allclose(np.asarray(x), x_ref, rtol=1e-2, atol=1e-3)


def test_bicgstab_nonsymmetric():
    # pdp08-pg4 is a real nonsymmetric sample; diagonally-dominant synth
    # keeps BiCGSTAB well-conditioned for the test.
    rng = np.random.RandomState(8)
    n = 30
    a = rng.randn(n, n) * (rng.rand(n, n) < 0.2)
    a += np.diag(np.abs(a).sum(axis=1) + 1.0)
    r, c = np.nonzero(a)
    coo = COOMatrix.from_numpy(
        r.astype(np.int32), c.astype(np.int32), a[r, c], shape=(n, n),
        pad_to=64,
    )
    csr = csr_encode(coo)
    import jax.numpy as jnp

    from smvp_toolkit_tpu.models import bicgstab

    b = jnp.asarray(rng.randn(n), jnp.float32)
    x, res = bicgstab(csr, b, num_iters=80)
    x_ref = np.linalg.solve(a, np.asarray(b, np.float64))
    np.testing.assert_allclose(np.asarray(x), x_ref, rtol=5e-2, atol=1e-3)
    assert float(res[-1]) < 1e-2 * float(res[0])


def test_solver_with_cusparse_route():
    # Solvers take the library route through the spmv seam.
    from smvp_toolkit_tpu.ops import spmv_csr_cusparse

    coo, a = _spd_coo(seed=6)
    import jax.numpy as jnp

    b = jnp.ones((a.shape[0],), jnp.float32)
    x, res = conjugate_gradient(
        csr_encode(coo), b, num_iters=100, spmv=spmv_csr_cusparse
    )
    x_ref = np.linalg.solve(a, np.ones(a.shape[0]))
    np.testing.assert_allclose(np.asarray(x), x_ref, rtol=1e-2, atol=1e-3)


def test_lanczos_extremal_eigenvalue():
    from smvp_toolkit_tpu.models import lanczos

    coo, a = _spd_coo(seed=7)
    csr = csr_encode(coo)
    import jax.numpy as jnp

    rng = np.random.RandomState(9)
    v0 = jnp.asarray(rng.randn(a.shape[0]), jnp.float32)
    alphas, betas, V = lanczos(csr, v0, num_iters=25)
    from scipy.linalg import eigh_tridiagonal

    al = np.asarray(alphas, np.float64)
    be = np.asarray(betas, np.float64)[:-1]
    ritz = eigh_tridiagonal(al, be, eigvals_only=True)
    true = np.linalg.eigvalsh(a)
    np.testing.assert_allclose(ritz.max(), true.max(), rtol=1e-3)


def test_cgls_rectangular_least_squares():
    from smvp_toolkit_tpu.models import cgls

    rng = np.random.RandomState(10)
    m, n = 60, 25
    dense = rng.randn(m, n) * (rng.rand(m, n) < 0.3)
    r, c = np.nonzero(dense)
    coo = COOMatrix.from_numpy(
        r.astype(np.int32), c.astype(np.int32), dense[r, c], shape=(m, n),
        pad_to=64,
    )
    coo_t = COOMatrix.from_numpy(
        c.astype(np.int32), r.astype(np.int32), dense[r, c], shape=(n, m),
        pad_to=64,
    )
    A = csr_encode(coo)
    At = csr_encode(coo_t)
    import jax.numpy as jnp

    b = jnp.asarray(rng.randn(m), jnp.float32)
    x, norms = cgls(A, At, b, num_iters=80)
    x_ref, *_ = np.linalg.lstsq(dense, np.asarray(b, np.float64), rcond=None)
    np.testing.assert_allclose(np.asarray(x), x_ref, rtol=5e-2, atol=5e-3)


# ---------------------------------------------------------------------------
# GCN layers (models/graph.py)
# ---------------------------------------------------------------------------


def test_gcn_norm_symmetric_normalization():
    import numpy as np

    from smvp_toolkit_tpu.formats.coo import COOMatrix
    from smvp_toolkit_tpu.models import gcn_norm

    r = np.array([0, 1, 1, 2], dtype=np.int32)
    c = np.array([1, 0, 2, 1], dtype=np.int32)
    v = np.ones(4)
    coo = COOMatrix.from_numpy(r, c, v, shape=(3, 3))
    s = gcn_norm(coo)
    dense = np.zeros((3, 3))
    rp = np.asarray(s.row_ptr)
    ci = np.asarray(s.col_ind)[: s.nnz]
    vv = np.asarray(s.vals)[: s.nnz]
    rows = np.repeat(np.arange(3), np.diff(rp))
    dense[rows, ci] = vv
    # Kipf-Welling normalization of A+I: symmetric, rows of D^-.5(A+I)D^-.5
    np.testing.assert_allclose(dense, dense.T, rtol=1e-6)
    a = np.array([[1, 1, 0], [1, 1, 1], [0, 1, 1]], dtype=np.float64)
    d = a.sum(1)
    expect = a / np.sqrt(d[:, None] * d[None, :])
    np.testing.assert_allclose(dense, expect, rtol=1e-6)


def test_gcn_training_learns():
    """A 2-layer GCN trained with gcn_train_step must drive the masked
    loss down on a separable toy graph (jit + scan, no host loops)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from smvp_toolkit_tpu.formats.coo import COOMatrix
    from smvp_toolkit_tpu.models import gcn_init, gcn_norm, gcn_train_step

    rng = np.random.RandomState(0)
    n = 64
    # two communities with dense intra-links
    labels = (np.arange(n) >= n // 2).astype(np.int32)
    rr, cc = [], []
    for _ in range(400):
        a, b = rng.randint(0, n // 2, 2)
        rr += [a, b]; cc += [b, a]
        a, b = rng.randint(n // 2, n, 2)
        rr += [a, b]; cc += [b, a]
    coo = COOMatrix.from_numpy(
        np.array(rr, np.int32), np.array(cc, np.int32),
        np.ones(len(rr)), shape=(n, n),
    )
    s = gcn_norm(coo)
    h = jnp.asarray(rng.randn(n, 8).astype(np.float32))
    params = gcn_init(jax.random.PRNGKey(0), [8, 16, 2])
    mask = jnp.ones((n,), jnp.float32)
    lab = jnp.asarray(labels)

    @jax.jit
    def train(params):
        def body(p, _):
            p, loss = gcn_train_step(s, p, h, lab, mask, lr=0.1)
            return p, loss

        return jax.lax.scan(body, params, None, length=60)

    _, losses = train(params)
    assert float(losses[-1]) < float(losses[0]) * 0.5
    assert float(losses[-1]) < 0.4


@pytest.mark.parametrize("restart,num_restarts", [(20, 2), (6, 3), (3, 10)])
def test_gmres_restart_longer_than_system(restart, num_restarts):
    """A restart longer than the Krylov space (m > n) hits the lucky
    breakdown; GMRES must still return the solution, not a basis of
    normalized rounding noise."""
    import jax.numpy as jnp
    import numpy as np

    from smvp_toolkit_tpu.formats.csr import csr_encode
    from smvp_toolkit_tpu.models import gmres
    from smvp_toolkit_tpu.utils.synth import sample_matrix

    coo = sample_matrix("pdp08-pg4")  # 6 x 6, nonsymmetric
    a = coo.to_dense()
    x, _ = gmres(csr_encode(coo.pad(64)), jnp.ones((6,), jnp.float32),
                 restart=restart, num_restarts=num_restarts)
    assert np.linalg.norm(1.0 - a @ np.asarray(x, np.float64)) < 1e-5


def test_gmres_nonsymmetric_system():
    """Restarted GMRES converges on a nonsymmetric diagonally-dominant
    system where CG's SPD assumption fails."""
    import jax.numpy as jnp
    import numpy as np

    from smvp_toolkit_tpu.formats.coo import COOMatrix
    from smvp_toolkit_tpu.formats.csr import csr_encode
    from smvp_toolkit_tpu.models import gmres

    rng = np.random.RandomState(5)
    n = 80
    dense = np.eye(n) * 10.0
    for _ in range(400):
        i, j = rng.randint(0, n, 2)
        if i != j:
            dense[i, j] += rng.randn() * 0.5  # nonsymmetric off-diagonals
    r, c = np.nonzero(dense)
    coo = COOMatrix.from_numpy(
        r.astype(np.int32), c.astype(np.int32), dense[r, c], shape=(n, n)
    )
    csr = csr_encode(coo)
    x_true = rng.randn(n).astype(np.float32)
    b = jnp.asarray(dense.astype(np.float32) @ x_true)
    x, res = gmres(csr, b, restart=20, num_restarts=4)
    assert float(res[-1]) < 1e-3 * float(jnp.linalg.norm(b))
    np.testing.assert_allclose(np.asarray(x), x_true, rtol=2e-3, atol=2e-3)


def test_pcg_beats_cg_on_illconditioned_diagonal():
    """Jacobi-preconditioned CG reaches a smaller residual than plain CG
    in the same iteration budget on a badly-scaled SPD system."""
    import jax.numpy as jnp
    import numpy as np

    from smvp_toolkit_tpu.formats.coo import COOMatrix
    from smvp_toolkit_tpu.formats.csr import csr_encode
    from smvp_toolkit_tpu.models import conjugate_gradient, pcg

    rng = np.random.RandomState(1)
    n = 100
    scales = 10.0 ** rng.uniform(-2, 2, n)
    dense = np.diag(scales)
    for _ in range(200):
        i, j = rng.randint(0, n, 2)
        if i < j:
            v = rng.randn() * 0.01 * np.sqrt(scales[i] * scales[j])
            dense[i, j] += v
            dense[j, i] += v
    r, c = np.nonzero(dense)
    csr = csr_encode(COOMatrix.from_numpy(
        r.astype(np.int32), c.astype(np.int32), dense[r, c], shape=(n, n)
    ))
    b = jnp.asarray(rng.randn(n).astype(np.float32))
    diag = jnp.asarray(scales.astype(np.float32))
    x_cg, res_cg = conjugate_gradient(csr, b, num_iters=30)
    x_pcg, res_pcg = pcg(csr, b, diag, num_iters=30)
    assert float(res_pcg[-1]) < float(res_cg[-1])
    assert float(res_pcg[-1]) < 1e-3 * float(jnp.linalg.norm(b))


# ---------------------------------------------------------------------------
# Chebyshev / MINRES / lanczos_eigsh (round 2 additions)
# ---------------------------------------------------------------------------


def test_chebyshev_solves_with_lanczos_bounds():
    from smvp_toolkit_tpu.models import chebyshev, lanczos_eigsh

    coo, a = _spd_coo(seed=11)
    csr = csr_encode(coo)
    import jax.numpy as jnp

    rng = np.random.RandomState(12)
    v0 = jnp.asarray(rng.randn(a.shape[0]), jnp.float32)
    lows, highs = lanczos_eigsh(csr, v0, num_iters=25, k=1)
    # Pad the Ritz bounds: interior eigenvalues may lie slightly outside.
    lmin = float(lows[0]) * 0.9
    lmax = float(highs[0]) * 1.1
    b = jnp.asarray(rng.randn(a.shape[0]), jnp.float32)
    x, res = chebyshev(csr, b, lmin, lmax, num_iters=150)
    x_ref = np.linalg.solve(a, np.asarray(b, np.float64))
    np.testing.assert_allclose(np.asarray(x), x_ref, rtol=1e-3, atol=1e-4)
    assert float(res[-1]) < float(res[0])


def test_minres_symmetric_indefinite():
    from smvp_toolkit_tpu.models import minres

    coo, a = _spd_coo(seed=13)
    # Shift to make the system indefinite but nonsingular (CG would fail).
    eig = np.linalg.eigvalsh(a)
    shift = (eig[0] + eig[1]) / 2.0 + 0.3 * (eig[1] - eig[0])
    a_ind = a - shift * np.eye(a.shape[0])
    assert np.linalg.eigvalsh(a_ind)[0] < 0 < np.linalg.eigvalsh(a_ind)[-1]
    r, c = np.nonzero(a_ind)
    coo_i = COOMatrix.from_numpy(
        r.astype(np.int32), c.astype(np.int32), a_ind[r, c],
        shape=a.shape, pad_to=64,
    )
    csr = csr_encode(coo_i)
    import jax.numpy as jnp

    rng = np.random.RandomState(14)
    b = jnp.asarray(rng.randn(a.shape[0]), jnp.float32)
    x, res = minres(csr, b, num_iters=120)
    x_ref = np.linalg.solve(a_ind, np.asarray(b, np.float64))
    np.testing.assert_allclose(np.asarray(x), x_ref, rtol=2e-3, atol=2e-3)
    # |eta| tracks the true residual norm.
    true_res = np.linalg.norm(a_ind @ np.asarray(x, np.float64)
                              - np.asarray(b, np.float64))
    np.testing.assert_allclose(float(res[-1]), true_res, rtol=0.3, atol=1e-3)


def test_lanczos_eigsh_extremal_bounds():
    from smvp_toolkit_tpu.models import lanczos_eigsh

    coo, a = _spd_coo(seed=15)
    csr = csr_encode(coo)
    import jax.numpy as jnp

    v0 = jnp.asarray(np.random.RandomState(16).randn(a.shape[0]),
                     jnp.float32)
    lows, highs = lanczos_eigsh(csr, v0, num_iters=25, k=2)
    true = np.linalg.eigvalsh(a)
    np.testing.assert_allclose(highs[-1], true[-1], rtol=1e-3)
    np.testing.assert_allclose(lows[0], true[0], rtol=0.1, atol=0.05)
    assert len(lows) == 2 and len(highs) == 2


def test_block_cg_multi_rhs():
    from smvp_toolkit_tpu.models import block_cg

    coo, a = _spd_coo(seed=17)
    csr = csr_encode(coo)
    import jax.numpy as jnp

    rng = np.random.RandomState(18)
    B = jnp.asarray(rng.randn(a.shape[0], 4), jnp.float32)
    X, res = block_cg(csr, B, num_iters=60)
    X_ref = np.linalg.solve(a, np.asarray(B, np.float64))
    np.testing.assert_allclose(np.asarray(X), X_ref, rtol=2e-3, atol=2e-4)
    # Residuals per column shrink.
    assert np.all(np.asarray(res)[-1] < np.asarray(res)[0])


def test_block_cg_beats_percolumn_iterations():
    """The block Krylov space converges in fewer iterations than
    single-RHS CG at equal iteration count (matched budget)."""
    from smvp_toolkit_tpu.models import block_cg, conjugate_gradient

    coo, a = _spd_coo(seed=19, n=40)
    csr = csr_encode(coo)
    import jax.numpy as jnp

    rng = np.random.RandomState(20)
    B = jnp.asarray(rng.randn(a.shape[0], 6), jnp.float32)
    iters = 8
    Xb, _ = block_cg(csr, B, num_iters=iters)
    err_b = 0.0
    err_s = 0.0
    X_ref = np.linalg.solve(a, np.asarray(B, np.float64))
    for j in range(B.shape[1]):
        xs, _ = conjugate_gradient(csr, B[:, j], num_iters=iters)
        err_s += np.linalg.norm(np.asarray(xs) - X_ref[:, j])
        err_b += np.linalg.norm(np.asarray(Xb)[:, j] - X_ref[:, j])
    assert err_b <= err_s


# ---------------------------------------------------------------------------
# Polynomial preconditioners (round 3)
# ---------------------------------------------------------------------------


def test_pcg_precond_jacobi_order1_matches_pcg():
    # order=1 truncated Neumann IS Jacobi scaling: pcg_precond must
    # reproduce pcg's residual trajectory exactly.
    import jax.numpy as jnp

    from smvp_toolkit_tpu.models import (
        jacobi_preconditioner, pcg, pcg_precond,
    )

    coo, a = _spd_coo(n=40, seed=21)
    csr = csr_encode(coo)
    b = jnp.asarray(np.random.RandomState(0).randn(40).astype(np.float32))
    diag = jnp.asarray(np.diag(a).astype(np.float32))
    x1, r1 = pcg(csr, b, diag, num_iters=20)
    m = jacobi_preconditioner(csr, diag, order=1)
    x2, r2 = pcg_precond(csr, b, m, num_iters=20)
    np.testing.assert_allclose(np.asarray(r2), np.asarray(r1),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(x2), np.asarray(x1),
                               rtol=1e-4, atol=1e-5)


def test_polynomial_preconditioners_accelerate_cg():
    # On an ill-conditioned SPD system both polynomial preconditioners
    # must beat plain CG at the same CG-iteration budget, and solve.
    import jax.numpy as jnp

    from smvp_toolkit_tpu.models import (
        chebyshev_preconditioner, conjugate_gradient,
        jacobi_preconditioner, lanczos_eigsh, pcg_precond,
    )

    rng = np.random.RandomState(5)
    n = 100
    scales = 10.0 ** rng.uniform(-2, 2, n)
    dense = np.diag(scales)
    for _ in range(200):
        i, j = rng.randint(0, n, 2)
        if i < j:
            v = rng.randn() * 0.01 * np.sqrt(scales[i] * scales[j])
            dense[i, j] += v
            dense[j, i] += v
    r, c = np.nonzero(dense)
    csr = csr_encode(COOMatrix.from_numpy(
        r.astype(np.int32), c.astype(np.int32), dense[r, c], shape=(n, n)
    ))
    b = jnp.asarray(rng.randn(n).astype(np.float32))
    bn = float(jnp.linalg.norm(b))
    x_ref = np.linalg.solve(dense, np.asarray(b, np.float64))

    _, res_cg = conjugate_gradient(csr, b, num_iters=25)

    diag = jnp.asarray(scales.astype(np.float32))
    m_neu = jacobi_preconditioner(csr, diag, order=3)
    x_n, res_n = pcg_precond(csr, b, m_neu, num_iters=25)
    assert float(res_n[-1]) < float(res_cg[-1])
    assert float(res_n[-1]) < 1e-3 * bn

    # The raw spectrum spans ~4 decades (scales 1e-2..1e2), so the
    # Chebyshev polynomial needs a higher degree than on well-scaled
    # systems; bounds come from a short Lanczos run.
    lows, highs = lanczos_eigsh(csr, b, num_iters=20)
    m_cheb = chebyshev_preconditioner(
        csr, 0.9 * float(lows[0]), 1.1 * float(highs[-1]), degree=12
    )
    # 40 CG iterations: the unconverged Lanczos low Ritz value sits
    # above the true lambda_min, so the polynomial under-damps the
    # lowest modes a little (expected with single-pass Lanczos).
    x_c, res_c = pcg_precond(csr, b, m_cheb, num_iters=40)
    assert float(res_c[-1]) < float(res_cg[-1])
    assert float(res_c[-1]) < 1e-3 * bn

    err = np.abs(np.asarray(x_c, np.float64) - x_ref).max()
    assert err / (np.abs(x_ref).max() + 1e-30) < 1e-2


def test_cg_tol_early_stop():
    # tol-mode CG stops as soon as |r|/|b| <= tol — entirely on device
    # (lax.while_loop) — and the residual history stays shape-stable
    # with the final norm repeated past the stopping step.
    import jax.numpy as jnp

    from smvp_toolkit_tpu.models import conjugate_gradient, pcg

    coo, a = _spd_coo(n=48, seed=9)
    csr = csr_encode(coo)
    b = jnp.asarray(np.random.RandomState(1).randn(48).astype(np.float32))
    bn = float(jnp.linalg.norm(b))

    x_full, res_full = conjugate_gradient(csr, b, num_iters=60)
    x_tol, res_tol = conjugate_gradient(csr, b, num_iters=60, tol=1e-2)

    assert res_tol.shape == res_full.shape
    # converged to tolerance, but stopped well before full accuracy
    assert float(res_tol[-1]) <= 1e-2 * bn
    assert float(res_tol[-1]) > 10 * float(res_full[-1])
    # history is constant after the stopping step
    stop = int(np.searchsorted(-np.asarray(res_tol), -1e-2 * bn))
    tail = np.asarray(res_tol)[stop:]
    assert np.all(tail == tail[0] if tail.size else True)
    # the tol-mode solution really satisfies the tolerance
    r = np.asarray(b, np.float64) - a @ np.asarray(x_tol, np.float64)
    assert np.linalg.norm(r) <= 1.5e-2 * bn

    # pcg passes tol through its pcg_precond delegation
    diag = jnp.asarray(np.diag(a).astype(np.float32))
    x_p, res_p = pcg(csr, b, diag, num_iters=60, tol=1e-2)
    assert float(res_p[-1]) <= 1e-2 * bn


def test_bicgstab_tol_early_stop():
    import jax.numpy as jnp

    from smvp_toolkit_tpu.models import bicgstab

    # nonsymmetric diagonally-dominant system
    rng = np.random.RandomState(12)
    n = 48
    a = np.eye(n) * 5.0
    for _ in range(4 * n):
        i, j = rng.randint(0, n, 2)
        a[i, j] += rng.randn() * 0.3
    r, c = np.nonzero(a)
    csr = csr_encode(COOMatrix.from_numpy(
        r.astype(np.int32), c.astype(np.int32), a[r, c], shape=(n, n)
    ))
    b = jnp.asarray(rng.randn(n).astype(np.float32))
    bn = float(jnp.linalg.norm(b))
    x_full, res_full = bicgstab(csr, b, num_iters=40)
    x_tol, res_tol = bicgstab(csr, b, num_iters=40, tol=1e-2)
    assert res_tol.shape == res_full.shape
    assert float(res_tol[-1]) <= 1e-2 * bn
    assert float(res_tol[-1]) > 10 * float(res_full[-1])
    rres = np.asarray(b, np.float64) - a @ np.asarray(x_tol, np.float64)
    assert np.linalg.norm(rres) <= 1.5e-2 * bn


def test_minres_tol_early_stop():
    """tol stops MINRES early on device; converged residual reported."""
    coo, a = _spd_coo(n=40, seed=23)
    csr = csr_encode(coo)
    b = np.random.RandomState(3).randn(40).astype(np.float32)
    from smvp_toolkit_tpu.models import minres

    x, res = minres(csr, b, num_iters=60, tol=1e-6)
    res = np.asarray(res)
    bn = np.linalg.norm(b)
    assert res[-1] / bn < 1e-5  # eta tracks the true residual
    r = b - a @ np.asarray(x, np.float64)
    assert np.linalg.norm(r) / bn < 1e-4
    # Early stop actually froze the tail (repeated final norm).
    hit = np.argmax(res / bn < 1e-6)
    assert hit < 59 and np.allclose(res[hit:], res[-1])


def test_gmres_tol_stops_between_restarts():
    coo, a = _spd_coo(n=40, seed=24)
    csr = csr_encode(coo)
    b = np.random.RandomState(4).randn(40).astype(np.float32)
    from smvp_toolkit_tpu.models import gmres

    x, res = gmres(csr, b, restart=10, num_restarts=8, tol=1e-6)
    res = np.asarray(res)
    bn = np.linalg.norm(b)
    assert res[-1] / bn < 1e-6
    r = b - a @ np.asarray(x, np.float64)
    assert np.linalg.norm(r) / bn < 1e-5
    hit = np.argmax(res / bn < 1e-6)
    assert np.allclose(res[hit:], res[-1])


def test_pagerank_tol_early_stop():
    """pagerank(tol=...) matches the fixed-iteration result and stays a
    probability vector."""
    import jax.numpy as jnp

    from smvp_toolkit_tpu.models import pagerank

    rng = np.random.RandomState(17)
    n = 80
    r = rng.randint(0, n, 400).astype(np.int32)
    c = rng.randint(0, n, 400).astype(np.int32)
    # column-stochastic link weights
    v = np.ones(400)
    colsum = np.zeros(n)
    np.add.at(colsum, c, v)
    v = v / colsum[c]
    coo = COOMatrix.from_numpy(r, c, v.astype(np.float32), shape=(n, n),
                               pad_to=64)
    csr = csr_encode(coo)
    pr_fixed = np.asarray(pagerank(csr, num_iters=200))
    pr_tol = np.asarray(pagerank(csr, num_iters=200, tol=1e-10))
    np.testing.assert_allclose(pr_tol, pr_fixed, rtol=1e-4, atol=1e-7)
    assert abs(pr_tol.sum() - 1.0) < 1e-4 and (pr_tol >= 0).all()


def test_power_iteration_tol_early_stop():
    from smvp_toolkit_tpu.models import power_iteration

    rng = np.random.RandomState(19)
    a = rng.randn(40, 40)
    a = a @ a.T  # SPD: dominant eigenpair well-defined
    r, c = np.nonzero(a)
    coo = COOMatrix.from_numpy(r.astype(np.int32), c.astype(np.int32),
                               a[r, c].astype(np.float32), shape=a.shape,
                               pad_to=64)
    csr = csr_encode(coo)
    import jax.numpy as jnp

    x0 = jnp.asarray(rng.randn(40).astype(np.float32))
    lam_f, _ = power_iteration(csr, x0, num_iters=300)
    lam_t, v = power_iteration(csr, x0, num_iters=300, tol=1e-6)
    true = np.linalg.eigvalsh(a)[-1]
    assert abs(float(lam_t) - true) / true < 1e-3
    assert abs(float(lam_t) - float(lam_f)) / true < 1e-3
    # eigenvector residual
    vv = np.asarray(v, np.float64)
    assert np.linalg.norm(a @ vv - float(lam_t) * vv) / true < 1e-2
