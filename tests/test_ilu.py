"""ILU(0)/IC(0) factorization + fixed-sweep Neumann triangular apply.

Covers the exact algebraic contracts (pattern identity, factor
triangularity, nilpotent-series exactness, symmetric-PD composite) and
the solver-level payoff (preconditioned CG/BiCGSTAB beating the plain
methods on a 2-D Poisson system).
"""

import numpy as np
import pytest

from smvp_toolkit_tpu.formats.coo import COOMatrix
from smvp_toolkit_tpu.formats.csr import csr_encode
from smvp_toolkit_tpu.models import (
    bicgstab,
    conjugate_gradient,
    ic0_preconditioner,
    ilu_preconditioner,
    pcg_precond,
)
from smvp_toolkit_tpu.ops.ilu import ic0, ilu0, trisolve_neumann


def _coo_from_dense(a, pad_to=64):
    r, c = np.nonzero(a)
    return COOMatrix.from_numpy(
        r.astype(np.int32), c.astype(np.int32), a[r, c],
        shape=a.shape, pad_to=pad_to,
    )


def _dense_factors_ilu(f):
    """(I + L, D_u + U) as dense f64 from the factor pytrees."""
    n = f.shape[0]
    low = np.eye(n)
    up = np.diag(np.asarray(f.u_diag, np.float64))
    for tri, dense in ((f.l_strict, low), (f.u_strict, up)):
        rp = np.asarray(tri.row_ptr)
        ci = np.asarray(tri.col_ind)
        v = np.asarray(tri.vals, np.float64)
        for i in range(n):
            for t in range(rp[i], rp[i + 1]):
                dense[i, ci[t]] += v[t]
    return low, up


def _dense_lower_ic(f):
    """L (strict + diag) as dense f64 from IC(0) factors."""
    n = f.shape[0]
    low = np.diag(np.asarray(f.diag, np.float64))
    rp = np.asarray(f.strict.row_ptr)
    ci = np.asarray(f.strict.col_ind)
    v = np.asarray(f.strict.vals, np.float64)
    for i in range(n):
        for t in range(rp[i], rp[i + 1]):
            low[i, ci[t]] += v[t]
    return low


def _random_sparse(n=20, seed=0, density=0.15):
    """Nonsymmetric sparse matrix with a safe diagonal."""
    rng = np.random.RandomState(seed)
    a = rng.randn(n, n) * (rng.rand(n, n) < density)
    np.fill_diagonal(a, np.abs(a).sum(axis=1) + 1.0)
    return a


def _poisson2d(nx=14):
    """5-point 2-D Laplacian on an nx × nx grid (SPD, cond ~ nx²)."""
    from conftest import poisson2d

    return poisson2d(nx)


def test_ilu0_pattern_identity():
    """(I+L)(D+U) matches A exactly on A's sparsity pattern (f32 tol)."""
    a = _random_sparse(seed=3)
    f = ilu0(csr_encode(_coo_from_dense(a)))
    low, up = _dense_factors_ilu(f)
    prod = low @ up
    mask = a != 0
    np.testing.assert_allclose(prod[mask], a[mask], rtol=2e-5, atol=2e-5)
    # Strict triangularity of the stored parts.
    assert np.allclose(np.triu(low), np.eye(a.shape[0]))
    assert np.allclose(np.tril(up, -1), 0)


def test_ilu0_dense_pattern_is_exact_lu():
    """With a full pattern there is nothing to drop: L·U == A."""
    rng = np.random.RandomState(7)
    a = rng.randn(12, 12)
    np.fill_diagonal(a, np.abs(a).sum(axis=1) + 1.0)
    f = ilu0(csr_encode(_coo_from_dense(a)))
    low, up = _dense_factors_ilu(f)
    np.testing.assert_allclose(low @ up, a, rtol=2e-5, atol=2e-5)


def test_ilu0_zero_pivot_warns_and_completes():
    a = np.array([[0.0, 2.0], [3.0, 4.0]])
    with pytest.warns(UserWarning, match="pivot"):
        f = ilu0(csr_encode(_coo_from_dense(a, pad_to=8)))
    low, up = _dense_factors_ilu(f)
    assert np.all(np.isfinite(low)) and np.all(np.isfinite(up))


def test_ic0_pattern_identity_and_pd():
    """L·Lᵀ matches A on the lower pattern; diag(L) > 0."""
    a = _poisson2d(8)
    f = ic0(csr_encode(_coo_from_dense(a)))
    low = _dense_lower_ic(f)
    prod = low @ low.T
    mask = np.tril(a != 0)
    np.testing.assert_allclose(prod[mask], a[mask], rtol=2e-5, atol=2e-5)
    assert np.all(np.asarray(f.diag) > 0)


def test_ic0_ignores_strict_upper():
    """Symmetric-stored (lower-only) and expanded inputs factor alike."""
    a = _poisson2d(6)
    f_full = ic0(csr_encode(_coo_from_dense(a)))
    f_low = ic0(csr_encode(_coo_from_dense(np.tril(a))))
    np.testing.assert_array_equal(
        np.asarray(f_full.diag), np.asarray(f_low.diag)
    )
    np.testing.assert_array_equal(
        np.asarray(f_full.strict.vals), np.asarray(f_low.strict.vals)
    )


def test_trisolve_exact_past_nilpotency():
    """Enough sweeps ⇒ the Neumann series equals the exact solve."""
    rng = np.random.RandomState(1)
    n = 10
    t = np.tril(rng.randn(n, n), -1)
    d = rng.rand(n) + 1.0
    r = rng.randn(n).astype(np.float32)
    strict = csr_encode(_coo_from_dense(t, pad_to=32))
    z = np.asarray(
        trisolve_neumann(strict, np.asarray(d, np.float32), r, sweeps=n)
    )
    z_ref = np.linalg.solve(t + np.diag(d), r.astype(np.float64))
    np.testing.assert_allclose(z, z_ref, rtol=1e-4, atol=1e-4)
    # Unit-diagonal variant (diag=None).
    z_unit = np.asarray(trisolve_neumann(strict, None, r, sweeps=n))
    z_unit_ref = np.linalg.solve(t + np.eye(n), r.astype(np.float64))
    np.testing.assert_allclose(z_unit, z_unit_ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("sweeps", [1, 2, 4])
def test_ic0_apply_is_symmetric_pd_at_any_sweeps(sweeps):
    """The composite P_Lᵀ·P_L is symmetric PD for EVERY sweep count.

    This is the property that makes the inexact apply CG-safe: with
    equal sweep counts the backward-solve polynomial is exactly the
    transpose of the forward one (ops/ilu.py module docstring).
    """
    a = _poisson2d(5)
    n = a.shape[0]
    apply_m = ic0_preconditioner(
        ic0(csr_encode(_coo_from_dense(a))), sweeps=sweeps
    )
    m = np.stack(
        [np.asarray(apply_m(np.eye(n, dtype=np.float32)[j]))
         for j in range(n)],
        axis=1,
    ).astype(np.float64)
    np.testing.assert_allclose(m, m.T, rtol=1e-4, atol=1e-5)
    assert np.linalg.eigvalsh((m + m.T) / 2).min() > 0


def test_pcg_ic0_beats_plain_cg_on_poisson():
    a = _poisson2d(14)
    coo = _coo_from_dense(a)
    csr = csr_encode(coo)
    rng = np.random.RandomState(5)
    b = rng.randn(a.shape[0]).astype(np.float32)

    iters = 14
    _, res_cg = conjugate_gradient(csr, b, num_iters=iters)
    m = ic0_preconditioner(ic0(csr), sweeps=4)
    x, res_pcg = pcg_precond(csr, b, m, num_iters=iters)

    assert float(res_pcg[-1]) < 0.2 * float(res_cg[-1])
    r = b - a @ np.asarray(x, np.float64)
    assert np.linalg.norm(r) / np.linalg.norm(b) < 1e-3


def test_bicgstab_ilu_right_preconditioning():
    """Wrapped-spmv right preconditioning: fewer iterations, true x."""
    a = _poisson2d(10)
    # Nonsymmetric perturbation (convection-like upwind terms).
    n = a.shape[0]
    rng = np.random.RandomState(9)
    for k in range(n - 1):
        if rng.rand() < 0.5:
            a[k, k + 1] -= 0.4
    coo = _coo_from_dense(a)
    csr = csr_encode(coo)
    b = rng.randn(n).astype(np.float32)

    m_apply = ilu_preconditioner(ilu0(csr), sweeps=4)
    iters = 10
    _, res_plain = bicgstab(csr, b, num_iters=iters)
    from smvp_toolkit_tpu.ops import spmv_csr

    u, res_pre = bicgstab(
        csr, b, num_iters=iters,
        spmv=lambda mat, v: spmv_csr(mat, m_apply(v)),
    )
    x = m_apply(u)
    assert float(res_pre[-1]) < float(res_plain[-1])
    r = b - a @ np.asarray(x, np.float64)
    # The solver's tracked residual IS the true residual of x = M⁻¹u.
    np.testing.assert_allclose(
        np.linalg.norm(r), float(res_pre[-1]), rtol=1e-2, atol=1e-4
    )


def test_ilu0_rejects_nonsquare_and_complex():
    rng = np.random.RandomState(2)
    rect = rng.randn(4, 6) * (rng.rand(4, 6) < 0.5)
    with pytest.raises(ValueError, match="square"):
        ilu0(csr_encode(_coo_from_dense(rect, pad_to=8)))
    a = _random_sparse(n=6, seed=11)
    r, c = np.nonzero(a)
    coo_c = COOMatrix.from_numpy(
        r.astype(np.int32), c.astype(np.int32),
        a[r, c].astype(np.complex64), shape=a.shape, pad_to=8,
        dtype=np.complex64,
    )
    with pytest.raises(ValueError, match="real"):
        ilu0(csr_encode(coo_c))


def test_ic0_shift_restart_on_indefinite_pattern_matrix():
    """pwt-class input (pattern values, indefinite): breakdown cascades
    must trigger the Manteuffel shift restart and yield FINITE factors,
    not an f64 overflow cascade (observed pre-fix on pwt.mtx)."""
    rng = np.random.RandomState(4)
    n = 60
    a = np.zeros((n, n))
    for _ in range(6 * n):
        i, j = rng.randint(0, n, 2)
        a[i, j] = a[j, i] = 1.0  # pattern matrix: all stored values 1
    np.fill_diagonal(a, 1.0)  # NOT diagonally dominant -> indefinite
    with pytest.warns(UserWarning, match="shift"):
        f = ic0(csr_encode(_coo_from_dense(a)))
    assert np.all(np.isfinite(np.asarray(f.strict.vals)))
    assert np.all(np.asarray(f.diag) > 0)
    low = _dense_lower_ic(f)
    assert np.all(np.isfinite(low))


def test_ilu0_shift_restart_keeps_factors_f32_safe():
    """Same cascade class through ilu0: factors stay in f32 range."""
    rng = np.random.RandomState(8)
    n = 60
    a = (rng.rand(n, n) < 0.1).astype(np.float64)
    np.fill_diagonal(a, (rng.rand(n) < 0.5) * 1.0)  # many zero diagonals
    with pytest.warns(UserWarning):
        f = ilu0(csr_encode(_coo_from_dense(a)))
    for arr in (f.l_strict.vals, f.u_strict.vals, f.u_diag):
        h = np.asarray(arr)
        assert np.all(np.isfinite(h)) and np.abs(h).max() < 1e30


def test_native_passes_bit_identical_to_numpy():
    """native/ilu.cpp mirrors the numpy passes operation-for-operation
    (built with -ffp-contract=off so FMA contraction cannot skew
    rounding); outputs must be EXACTLY equal, not just close."""
    from smvp_toolkit_tpu.ops import ilu as M

    native_ilu = M._native_ilu0_pass()
    native_ic = M._native_ic0_pass()
    if native_ilu is None:
        pytest.skip("libilu.so not built")
    rng = np.random.RandomState(42)
    for n in (17, 60, 150):
        a = rng.randn(n, n) * (rng.rand(n, n) < 0.15)
        np.fill_diagonal(a, np.abs(a).sum(1) + 1.0)
        csr = csr_encode(_coo_from_dense(a))
        rp, ci, v = M._csr_host(csr)
        for shift in (0.0, 0.5):
            f1, d1, x1 = M._ilu0_pass(rp, ci, v, n, shift, 1e-8)
            f2, d2, x2 = native_ilu(rp, ci, v, n, shift, 1e-8)
            np.testing.assert_array_equal(f1, f2)
            np.testing.assert_array_equal(d1, d2)
            assert x1 == x2
            g1 = M._ic0_pass(rp, ci, v, n, shift, 1e-8)
            g2 = native_ic(rp, ci, v, n, shift, 1e-8)
            for a1, a2 in zip(g1, g2):
                np.testing.assert_array_equal(np.asarray(a1),
                                              np.asarray(a2))


def test_python_fallback_matches_default_path():
    """SMVP_NATIVE_ILU=0 (pure numpy) factors a system identically
    enough to solve it: same preconditioned convergence."""
    import os

    from smvp_toolkit_tpu.ops import ilu as M

    a = _poisson2d(8)
    csr = csr_encode(_coo_from_dense(a))
    f_default = ic0(csr)
    old = os.environ.get("SMVP_NATIVE_ILU")
    old_lib, old_failed = M._ILU_LIB, M._ILU_LIB_FAILED
    os.environ["SMVP_NATIVE_ILU"] = "0"
    M._ILU_LIB, M._ILU_LIB_FAILED = None, False
    try:
        f_py = ic0(csr)
    finally:
        M._ILU_LIB, M._ILU_LIB_FAILED = old_lib, old_failed
        if old is None:
            os.environ.pop("SMVP_NATIVE_ILU", None)
        else:
            os.environ["SMVP_NATIVE_ILU"] = old
    np.testing.assert_array_equal(
        np.asarray(f_default.diag), np.asarray(f_py.diag)
    )
    np.testing.assert_array_equal(
        np.asarray(f_default.strict.vals), np.asarray(f_py.strict.vals)
    )


def _cusparse_op(csr):
    """op_builder for the cuSPARSE route (generic lowering on CPU)."""
    from functools import partial

    from smvp_toolkit_tpu.ops import spmv_csr_cusparse

    return partial(spmv_csr_cusparse, csr)


def test_preconditioner_on_cusparse_operators_matches_xla():
    """op_builder puts the trisolves on another kernel (here the
    cuSPARSE route); the apply must match the default XLA trisolve."""

    a = _poisson2d(6)
    csr = csr_encode(_coo_from_dense(a))
    f = ic0(csr)
    rng = np.random.RandomState(3)
    r = rng.randn(a.shape[0]).astype(np.float32)
    m_xla = ic0_preconditioner(f, sweeps=3)
    m_lib = ic0_preconditioner(f, sweeps=3, op_builder=_cusparse_op)
    np.testing.assert_allclose(
        np.asarray(m_lib(r)), np.asarray(m_xla(r)), rtol=1e-5, atol=1e-6
    )

    fu = ilu0(csr)
    m_xla_u = ilu_preconditioner(fu, sweeps=3)
    m_lib_u = ilu_preconditioner(fu, sweeps=3, op_builder=_cusparse_op)
    np.testing.assert_allclose(
        np.asarray(m_lib_u(r)), np.asarray(m_xla_u(r)),
        rtol=1e-5, atol=1e-6,
    )


def test_ssor_preconditioner_symmetric_and_accelerates_cg():
    """SSOR apply is exactly symmetric PD for symmetric A (equal-sweep
    transpose argument) and speeds CG up on Poisson without any
    factorization setup."""
    from smvp_toolkit_tpu.models import ssor_preconditioner

    a = _poisson2d(5)
    n = a.shape[0]
    csr = csr_encode(_coo_from_dense(a))
    apply_m = ssor_preconditioner(csr, omega=1.0, sweeps=3)
    m = np.stack(
        [np.asarray(apply_m(np.eye(n, dtype=np.float32)[j]))
         for j in range(n)],
        axis=1,
    ).astype(np.float64)
    np.testing.assert_allclose(m, m.T, rtol=1e-4, atol=1e-5)
    assert np.linalg.eigvalsh((m + m.T) / 2).min() > 0

    big = _poisson2d(14)
    csr_b = csr_encode(_coo_from_dense(big))
    rng = np.random.RandomState(2)
    b = rng.randn(big.shape[0]).astype(np.float32)
    iters = 14
    _, res_cg = conjugate_gradient(csr_b, b, num_iters=iters)
    mb = ssor_preconditioner(csr_b, omega=1.0, sweeps=4)
    x, res_ssor = pcg_precond(csr_b, b, mb, num_iters=iters)
    assert float(res_ssor[-1]) < 0.5 * float(res_cg[-1])
    r = b - big @ np.asarray(x, np.float64)
    assert np.linalg.norm(r) / np.linalg.norm(b) < 1e-2


def test_ssor_omega_validation_and_cusparse_path():
    from smvp_toolkit_tpu.models import ssor_preconditioner


    a = _poisson2d(5)
    csr = csr_encode(_coo_from_dense(a))
    with pytest.raises(ValueError, match="omega"):
        ssor_preconditioner(csr, omega=2.0)
    rng = np.random.RandomState(6)
    r = rng.randn(a.shape[0]).astype(np.float32)
    m_xla = ssor_preconditioner(csr, omega=1.3, sweeps=3)
    m_lib = ssor_preconditioner(
        csr, omega=1.3, sweeps=3, op_builder=_cusparse_op
    )
    np.testing.assert_allclose(
        np.asarray(m_lib(r)), np.asarray(m_xla(r)), rtol=1e-5, atol=1e-6
    )


def test_block_jacobi_preconditioner():
    """Dense block inverses: exact on one block, symmetric PD, and
    line-blocks accelerate Poisson CG beyond pointwise Jacobi."""
    from smvp_toolkit_tpu.models import block_jacobi_preconditioner

    a = _poisson2d(6)
    n = a.shape[0]
    csr = csr_encode(_coo_from_dense(a))

    # block >= n: M = A exactly, so apply == dense solve.
    apply_full = block_jacobi_preconditioner(csr, block=n)
    rng = np.random.RandomState(7)
    r = rng.randn(n).astype(np.float32)
    np.testing.assert_allclose(
        np.asarray(apply_full(r)),
        np.linalg.solve(a, r.astype(np.float64)),
        rtol=1e-4, atol=1e-4,
    )

    # Symmetric PD composite at a line-block size (6 = one grid row),
    # including the padded-tail case (block 5 does not divide 36).
    for blk in (6, 5):
        apply_m = block_jacobi_preconditioner(csr, block=blk)
        m = np.stack(
            [np.asarray(apply_m(np.eye(n, dtype=np.float32)[j]))
             for j in range(n)],
            axis=1,
        ).astype(np.float64)
        np.testing.assert_allclose(m, m.T, rtol=1e-4, atol=1e-5)
        assert np.linalg.eigvalsh((m + m.T) / 2).min() > 0

    # Line relaxation beats pointwise Jacobi. Scale Poisson by a varied
    # SPD congruence (S A S) so the diagonal is non-constant — on plain
    # Poisson the diagonal is constant and pointwise Jacobi degenerates
    # to unpreconditioned CG, which would make this comparison vacuous.
    from smvp_toolkit_tpu.models import pcg
    from smvp_toolkit_tpu.ops.algebra import diagonal

    big = _poisson2d(14)
    n2 = big.shape[0]
    s = 1.0 + np.arange(n2) / n2
    big = big * np.outer(s, s)
    coo_b = _coo_from_dense(big)
    csr_b = csr_encode(coo_b)
    b = rng.randn(n2).astype(np.float32)
    iters = 14
    _, res_j = pcg(csr_b, b, diagonal(coo_b), num_iters=iters)
    mb = block_jacobi_preconditioner(csr_b, block=14)
    _, res_bj = pcg_precond(csr_b, b, mb, num_iters=iters)
    assert float(res_bj[-1]) < float(res_j[-1])


def test_block_jacobi_empty_diag_rows_are_identity():
    """Structurally missing diagonals become identity rows, not ridge
    casualties: the apply passes those components through unchanged and
    no singular-block warning fires."""
    import warnings

    from smvp_toolkit_tpu.models import block_jacobi_preconditioner

    a = np.array([[0.0, 1.0], [1.0, 0.0]])  # no stored diagonal at all
    csr = csr_encode(_coo_from_dense(a, pad_to=8))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        apply_m = block_jacobi_preconditioner(csr, block=1)
    r = np.array([2.0, 3.0], np.float32)
    np.testing.assert_allclose(np.asarray(apply_m(r)), r)


def test_block_jacobi_singular_block_ridged():
    """A numerically singular STORED block is ridged — and only it: the
    healthy block keeps its exact inverse."""
    from smvp_toolkit_tpu.models import block_jacobi_preconditioner

    a = np.array([
        [1.0, 1.0, 0.0, 0.0],
        [1.0, 1.0, 0.0, 0.0],
        [0.0, 0.0, 2.0, 0.0],
        [0.0, 0.0, 0.0, 4.0],
    ])
    csr = csr_encode(_coo_from_dense(a, pad_to=8))
    with pytest.warns(UserWarning, match="singular"):
        apply_m = block_jacobi_preconditioner(csr, block=2)
    z = np.asarray(apply_m(np.ones(4, np.float32)))
    assert np.all(np.isfinite(z))
    np.testing.assert_allclose(z[2:], [0.5, 0.25], rtol=1e-6)
