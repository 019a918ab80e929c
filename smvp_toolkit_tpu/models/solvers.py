"""Iterative solvers on encoded sparse matrices (CSR by default).

All solvers are structured for XLA: fixed iteration counts via
``lax.scan``/``fori_loop`` (static trip counts, no data-dependent Python
control flow), optional early-exit via ``lax.while_loop`` with on-device
convergence checks. Any SpMV implementation with the ``spmv(matrix, x)``
signature can be injected (XLA, cuSPARSE or sharded).
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Optional

import jax
import jax.numpy as jnp

from smvp_toolkit_tpu.ops.spmv_xla import spmv_csr

# Dense products (Gram matrices, Rayleigh-Ritz, GMRES update, block
# inverses) run at full f32: on a GPU a default-precision f32 product
# may run in TF32 (~3 decimal digits), which the Krylov recurrences and
# the tests' f32 tolerances do not allow for.
_HIGHEST = jax.lax.Precision.HIGHEST


def _mm(a: jax.Array, b: jax.Array) -> jax.Array:
    return jnp.matmul(a, b, precision=_HIGHEST)


__all__ = [
    "power_iteration",
    "pagerank",
    "conjugate_gradient",
    "bicgstab",
    "jacobi",
    "lanczos",
    "cgls",
    "gmres",
    "pcg",
    "pcg_precond",
    "jacobi_preconditioner",
    "chebyshev_preconditioner",
    "chebyshev",
    "minres",
    "lanczos_eigsh",
    "lobpcg",
    "block_cg",
    "refine_solve",
    "ic0_preconditioner",
    "ilu_preconditioner",
    "ssor_preconditioner",
    "block_jacobi_preconditioner",
]


@partial(jax.jit, static_argnames=("num_iters", "spmv", "tol"))
def power_iteration(
    matrix,
    x0: jax.Array,
    num_iters: int = 50,
    spmv: Callable = spmv_csr,
    tol: Optional[float] = None,
):
    """Dominant eigenpair by repeated SpMV + normalization.

    Returns (eigenvalue estimate, eigenvector). ``num_iters`` is static —
    the loop is a ``lax.scan`` compiled once. ``tol``: optional
    on-device early stop (``lax.while_loop``) when the normalization
    factor — the eigenvalue estimate — changes by less than ``tol``
    between steps.
    """
    x0 = x0 / jnp.linalg.norm(x0)

    def advance(x):
        y = spmv(matrix, x)
        norm = jnp.linalg.norm(y)
        return y / jnp.maximum(norm, 1e-30), norm

    if tol is None:
        x_final, norms = jax.lax.scan(
            lambda x, _: advance(x), x0, None, length=num_iters
        )
        # Rayleigh-quotient-ish estimate from the last normalization.
        return norms[-1], x_final

    def cond(st):
        i, _x, prev, cur = st
        return (i < num_iters) & (jnp.abs(cur - prev) > tol)

    def body(st):
        i, x, _prev, cur = st
        x_new, norm = advance(x)
        return i + 1, x_new, cur, norm

    rdt = jnp.zeros((), x0.dtype).real.dtype
    _, x_final, _, lam = jax.lax.while_loop(
        cond, body,
        (0, x0, jnp.asarray(jnp.inf, rdt), jnp.asarray(0.0, rdt)),
    )
    return lam, x_final


@partial(jax.jit, static_argnames=("num_iters", "spmv", "tol"))
def pagerank(
    matrix,
    damping: float = 0.85,
    num_iters: int = 50,
    spmv: Callable = spmv_csr,
    tol: Optional[float] = None,
):
    """PageRank over a (column-stochastic) link matrix via iterated SpMV.

    ``tol``: optional L1-change target — the power iteration contracts
    geometrically (factor ``damping``), so an on-device early stop
    (``lax.while_loop``, same pattern as the solver family) saves the
    remaining SpMVs once ``|r_new − r|_1 <= tol``.
    """
    n = matrix.shape[1]
    r = jnp.full((n,), 1.0 / n, dtype=matrix.vals.dtype)

    def advance(r):
        r_new = damping * spmv(matrix, r) + (1.0 - damping) / n
        return r_new / jnp.maximum(r_new.sum(), 1e-30)

    if tol is None:
        r_final, _ = jax.lax.scan(
            lambda rr, _: (advance(rr), None), r, None, length=num_iters
        )
        return r_final

    def cond(st):
        i, _r, delta = st
        return (i < num_iters) & (delta > tol)

    def body(st):
        i, rr, _ = st
        r_new = advance(rr)
        return i + 1, r_new, jnp.abs(r_new - rr).sum()

    _, r_final, _ = jax.lax.while_loop(
        cond, body, (0, r, jnp.asarray(jnp.inf, r.dtype))
    )
    return r_final


def _while_solve(step, carry0, b, num_iters, tol):
    """Run ``carry -> (carry, |r|)`` under ``lax.while_loop`` until the
    relative residual reaches ``tol`` or ``num_iters`` steps.

    Returns ``(carry[0], res_norms)`` where ``res_norms`` keeps the
    static ``num_iters`` length — entries past the stopping step repeat
    the final norm so ``res[-1]`` is always the converged residual.
    The first carry element must be the solution vector x.
    """
    rdt = jnp.zeros((), b.dtype).real.dtype
    target = tol * jnp.maximum(jnp.linalg.norm(b).astype(rdt), 1e-30)
    hist0 = jnp.zeros((num_iters,), rdt)

    def cond(st):
        i, _carry, _hist, last = st
        return (i < num_iters) & (last > target)

    def body(st):
        i, carry, hist, _ = st
        carry, nrm = step(carry)
        nrm = nrm.astype(rdt)
        return i + 1, carry, hist.at[i].set(nrm), nrm

    i, carry, hist, last = jax.lax.while_loop(
        cond, body, (0, carry0, hist0, jnp.asarray(jnp.inf, rdt))
    )
    res = jnp.where(jnp.arange(num_iters) < i, hist, last)
    return carry[0], res


@partial(jax.jit, static_argnames=("num_iters", "spmv", "tol"))
def conjugate_gradient(
    matrix,
    b: jax.Array,
    x0: Optional[jax.Array] = None,
    num_iters: int = 50,
    spmv: Callable = spmv_csr,
    tol: Optional[float] = None,
):
    """Solve A x = b for symmetric positive-definite A by CG.

    Fixed ``num_iters`` steps under ``lax.scan`` (convergence is read off
    the returned residual norms host-side; no per-step host sync).

    ``tol``: optional RELATIVE residual target (|r|/|b|). When set, the
    loop runs under ``lax.while_loop`` and stops at the first of
    ``num_iters`` / tolerance — still entirely on device (no per-step
    host sync; the device runs data-dependent trip counts), saving the
    remaining SpMVs in serving paths. The returned residual-norm array
    keeps the static ``num_iters`` length; entries past the stopping
    step repeat the final norm, so ``res[-1]`` is the converged
    residual either way.
    """
    x = jnp.zeros_like(b) if x0 is None else x0
    r = b - spmv(matrix, x)
    p = r
    rs = jnp.vdot(r, r)

    def step(carry):
        x, r, p, rs = carry
        ap = spmv(matrix, p)
        denom = jnp.vdot(p, ap)
        alpha = rs / jnp.maximum(denom, 1e-30)
        x = x + alpha * p
        r = r - alpha * ap
        rs_new = jnp.vdot(r, r)
        beta = rs_new / jnp.maximum(rs, 1e-30)
        p = r + beta * p
        return (x, r, p, rs_new), jnp.sqrt(jnp.abs(rs_new))

    if tol is None:
        (x, r, p, rs), res_norms = jax.lax.scan(
            lambda c, _: step(c), (x, r, p, rs), None, length=num_iters
        )
        return x, res_norms
    return _while_solve(step, (x, r, p, rs), b, num_iters, tol)


@partial(jax.jit, static_argnames=("num_iters", "spmv", "tol"))
def bicgstab(
    matrix,
    b: jax.Array,
    x0: Optional[jax.Array] = None,
    num_iters: int = 50,
    spmv: Callable = spmv_csr,
    tol: Optional[float] = None,
):
    """Solve A x = b for general (nonsymmetric) A by BiCGSTAB.

    The nonsymmetric companion to :func:`conjugate_gradient` (the sample
    matrices pdp08-pg4/memplus are nonsymmetric). Fixed step count under
    ``lax.scan``; residual norms returned for host-side convergence
    checks. ``tol`` enables on-device early stop exactly as in
    :func:`conjugate_gradient` (each saved step saves TWO SpMVs here).
    """
    x = jnp.zeros_like(b) if x0 is None else x0
    r = b - spmv(matrix, x)
    r_hat = r
    rho = jnp.vdot(r_hat, r)
    p = r

    def step(carry):
        x, r, p, rho = carry
        v = spmv(matrix, p)
        alpha = rho / jnp.where(
            jnp.abs(jnp.vdot(r_hat, v)) > 1e-30, jnp.vdot(r_hat, v), 1e-30
        )
        s = r - alpha * v
        t = spmv(matrix, s)
        tt = jnp.vdot(t, t)
        omega = jnp.vdot(t, s) / jnp.where(jnp.abs(tt) > 1e-30, tt, 1e-30)
        x = x + alpha * p + omega * s
        r = s - omega * t
        rho_new = jnp.vdot(r_hat, r)
        beta = (rho_new / jnp.where(jnp.abs(rho) > 1e-30, rho, 1e-30)) * (
            alpha / jnp.where(jnp.abs(omega) > 1e-30, omega, 1e-30)
        )
        p = r + beta * (p - omega * v)
        return (x, r, p, rho_new), jnp.linalg.norm(r)

    if tol is not None:
        return _while_solve(step, (x, r, p, rho), b, num_iters, tol)
    (x, r, p, rho), res_norms = jax.lax.scan(
        lambda c, _: step(c), (x, r, p, rho), None, length=num_iters
    )
    return x, res_norms


@partial(jax.jit, static_argnames=("num_iters", "spmv"))
def lanczos(
    matrix,
    v0: jax.Array,
    num_iters: int = 30,
    spmv: Callable = spmv_csr,
):
    """Lanczos tridiagonalization of a symmetric A (extremal eigenvalues).

    Returns (alphas, betas, V): the tridiagonal coefficients (whose
    eigenvalues approximate A's extremal spectrum — compute them host-side
    with ``scipy.linalg.eigh_tridiagonal``) and the Krylov basis. Full
    reorthogonalization is omitted (single-pass classic Lanczos).
    """
    n = v0.shape[0]
    v = v0 / jnp.linalg.norm(v0)

    def step(carry, _):
        v_prev, v_cur, beta_prev = carry
        w = spmv(matrix, v_cur) - beta_prev * v_prev
        alpha = jnp.vdot(v_cur, w)
        w = w - alpha * v_cur
        beta = jnp.linalg.norm(w)
        v_next = w / jnp.maximum(beta, 1e-30)
        return (v_cur, v_next, beta), (alpha, beta, v_cur)

    (_, _, _), (alphas, betas, V) = jax.lax.scan(
        step,
        (jnp.zeros((n,), v.dtype), v, jnp.asarray(0.0, v.dtype)),
        None,
        length=num_iters,
    )
    return alphas, betas, V


@partial(jax.jit, static_argnames=("num_iters", "spmv", "spmv_t"))
def cgls(
    matrix,
    matrix_t,
    b: jax.Array,
    num_iters: int = 50,
    spmv: Callable = spmv_csr,
    spmv_t: Callable = spmv_csr,
):
    """Least-squares min ||A x - b|| via CGLS (CG on the normal equations).

    ``matrix_t`` is the encoded transpose (encode Aᵀ once host-side);
    works for rectangular systems. Returns (x, residual norms of Aᵀr).
    """
    x = jnp.zeros((matrix.shape[1],), b.dtype)
    r = b
    s = spmv_t(matrix_t, r)
    p = s
    gamma = jnp.vdot(s, s)

    def step(carry, _):
        x, r, p, gamma = carry
        q = spmv(matrix, p)
        alpha = gamma / jnp.maximum(jnp.vdot(q, q), 1e-30)
        x = x + alpha * p
        r = r - alpha * q
        s = spmv_t(matrix_t, r)
        gamma_new = jnp.vdot(s, s)
        beta = gamma_new / jnp.maximum(gamma, 1e-30)
        p = s + beta * p
        return (x, r, p, gamma_new), jnp.sqrt(gamma_new)

    (x, r, p, gamma), norms = jax.lax.scan(
        step, (x, r, p, gamma), None, length=num_iters
    )
    return x, norms


@partial(jax.jit, static_argnames=("num_iters", "spmv"))
def jacobi(
    matrix,
    b: jax.Array,
    diag: jax.Array,
    num_iters: int = 50,
    spmv: Callable = spmv_csr,
):
    """Jacobi iteration x ← x + D⁻¹ (b − A x) (requires nonzero diagonal)."""
    x = jnp.zeros_like(b)
    inv_d = 1.0 / jnp.where(jnp.abs(diag) > 1e-30, diag, 1.0)

    def step(x, _):
        return x + inv_d * (b - spmv(matrix, x)), None

    x_final, _ = jax.lax.scan(step, x, None, length=num_iters)
    return x_final


def _precond_block(m, r):
    """Apply preconditioner ``m`` to an (n, k) residual block.

    Block-capable appliers DECLARE it (``m.supports_block``, e.g. the
    AMG factory) and take the whole block in one call; anything else is
    applied per column. One definition for block_cg and lobpcg — shape
    sniffing instead would silently accept broadcasting accidents when
    k == n.
    """
    if m is None:
        return r
    if getattr(m, "supports_block", False):
        return m(r)
    return jnp.stack(
        [m(r[:, j]) for j in range(r.shape[1])], axis=1
    )



@partial(jax.jit, static_argnames=("num_iters", "spmm", "m"))
def block_cg(
    matrix,
    b: jax.Array,
    x0: Optional[jax.Array] = None,
    num_iters: int = 50,
    spmm: Callable = None,
    m: Optional[Callable] = None,
):
    """Block (P)CG (O'Leary): solve A X = B for a block of k RHS at once.

    One SpMM per step serves all k right-hand sides — the matrix planes
    cross HBM once per iteration instead of once per RHS, and the block
    Krylov space converges in fewer iterations than k independent CG
    runs. The k×k Gram solves run as dense ops on device. ``B`` is
    (n, k); returns (X, residual_norms (num_iters, k)).

    ``m`` is an optional SPD preconditioner per the pcg factory
    contract; block-capable appliers (``m.supports_block``, e.g.
    :func:`~smvp_toolkit_tpu.models.amg.amg_preconditioner`) receive
    the whole residual block — ONE k-wide V-cycle per iteration —
    while vector-only factories apply per column.
    """
    if spmm is None:
        from smvp_toolkit_tpu.ops.spmv_xla import spmm_csr as spmm
    k = b.shape[1]

    m_mul = lambda r: _precond_block(m, r)  # noqa: E731

    x = jnp.zeros_like(b) if x0 is None else x0
    r = b - spmm(matrix, x)
    z = m_mul(r)
    p = z
    gram = _mm(r.T, z)  # (k, k)
    eye = jnp.eye(k, dtype=b.dtype)

    def _solve(g, rhs):
        # Tiny ridge keeps the Gram solve stable once columns converge
        # (near-singular Gram ⇒ directions already exhausted).
        return jnp.linalg.solve(g + 1e-12 * eye, rhs)

    def step(carry, _):
        x, r, p, gram = carry
        q = spmm(matrix, p)
        alpha = _solve(_mm(p.T, q), gram)
        x = x + _mm(p, alpha)
        r = r - _mm(q, alpha)
        z = m_mul(r)
        gram_new = _mm(r.T, z)
        beta = _solve(gram, gram_new)
        p = z + _mm(p, beta)
        return (x, r, p, gram_new), jnp.linalg.norm(r, axis=0)

    (x, r, p, gram), res_norms = jax.lax.scan(
        step, (x, r, p, gram), None, length=num_iters
    )
    return x, res_norms


def refine_solve(
    matrix,
    b,
    *,
    inner: Callable,
    num_refinements: int = 3,
    vals_lo: Optional[jax.Array] = None,
):
    """Mixed-precision iterative refinement: ~f64-quality solves on
    f32 hardware.

    Classic Wilkinson refinement with the double-float machinery from
    ``ops/precision``: x lives as a df64 pair, the residual
    ``r = b − A·x`` is computed with the compensated df64 SpMV, ANY
    f32 inner solver supplies the correction ``d ≈ A⁻¹r`` (an
    AMG-preconditioned PCG closure is the natural choice), and
    ``x += d`` accumulates error-free. Each sweep multiplies the error
    by the inner solve's contraction factor down to the df64 floor
    (~1e-14 relative) — far below the ~1e-6 floor of a plain f32
    solve. ``vals_lo`` carries the low words of f64 matrix values
    (``df_split``) when the operator itself exceeds f32.

    ``inner(r) -> d`` takes and returns f32 vectors; ``b`` may be f32
    or f64 (host/device). Returns ``(x_hi, x_lo, res_norms)`` with one
    f64-accurate residual norm per sweep (length num_refinements).
    """
    import numpy as np

    from smvp_toolkit_tpu.ops.precision import (
        _df_add,
        df_split,
        df_to_f64,
        spmv_csr_df64,
    )

    b64 = np.asarray(b, np.float64)
    b_hi, b_lo = df_split(b64)
    x_hi = jnp.zeros_like(b_hi)
    x_lo = jnp.zeros_like(b_hi)
    norms = []
    for _ in range(num_refinements):
        y_hi, y_lo = spmv_csr_df64(matrix, x_hi, x_lo, vals_lo)
        ny_hi, ny_lo = -y_hi, -y_lo
        r_hi, r_lo = _df_add((b_hi, b_lo), (ny_hi, ny_lo))
        norms.append(float(np.linalg.norm(
            np.asarray(df_to_f64(r_hi, r_lo), np.float64)
        )))
        d = inner(r_hi.astype(jnp.float32))
        x_hi, x_lo = _df_add((x_hi, x_lo), (d, jnp.zeros_like(d)))
    return x_hi, x_lo, np.asarray(norms)


@partial(jax.jit, static_argnames=("num_iters", "spmv"))
def chebyshev(
    matrix,
    b: jax.Array,
    lambda_min: float,
    lambda_max: float,
    x0: Optional[jax.Array] = None,
    num_iters: int = 50,
    spmv: Callable = spmv_csr,
):
    """Chebyshev iteration for SPD A with spectrum in [lambda_min, lambda_max].

    The *inner-product-free* Krylov method: each step is one SpMV plus
    AXPYs — no global reductions at all, which makes it the
    communication-optimal choice on a sharded mesh (CG needs two
    all-reduce dot products per step; Chebyshev needs zero). Spectrum
    bounds can come from :func:`lanczos_eigsh` (a few iterations give
    tight-enough estimates). Returns (x, residual_norms) — the norms are
    computed for observability but do not steer the iteration.
    """
    theta = (lambda_max + lambda_min) / 2.0
    delta = (lambda_max - lambda_min) / 2.0
    sigma1 = theta / delta
    x = jnp.zeros_like(b) if x0 is None else x0
    r = b - spmv(matrix, x)
    d = r / theta
    rho = 1.0 / sigma1

    def step(carry, _):
        x, r, d, rho = carry
        x = x + d
        r = r - spmv(matrix, d)
        rho_new = 1.0 / (2.0 * sigma1 - rho)
        d = rho_new * rho * d + (2.0 * rho_new / delta) * r
        return (x, r, d, rho_new), jnp.linalg.norm(r)

    (x, r, d, rho), res_norms = jax.lax.scan(
        step, (x, r, d, rho), None, length=num_iters
    )
    return x, res_norms


@partial(jax.jit, static_argnames=("num_iters", "spmv", "tol"))
def minres(
    matrix,
    b: jax.Array,
    x0: Optional[jax.Array] = None,
    num_iters: int = 50,
    spmv: Callable = spmv_csr,
    tol: Optional[float] = None,
):
    """MINRES for symmetric (possibly *indefinite*) A (Paige & Saunders).

    Fills the gap between CG (needs positive-definite) and GMRES (needs
    the full Krylov basis in memory): a three-term Lanczos recurrence
    with on-the-fly Givens QR — O(1) vectors of state, safe for saddle
    systems. Returns (x, residual_norms); ``|eta|`` tracks the true
    residual norm of the minimum-residual iterate. ``tol`` enables
    on-device early stop exactly as in :func:`conjugate_gradient`
    (``|eta|`` is the monitored quantity).
    """
    x = jnp.zeros_like(b) if x0 is None else x0
    r0 = b - spmv(matrix, x)
    beta1 = jnp.linalg.norm(r0)
    v = r0 / jnp.maximum(beta1, 1e-30)
    zero = jnp.zeros_like(b)

    def step(carry, _):
        (x, v_prev, v, beta, eta, g0, g1, s0, s1, w2, w1) = carry
        # Lanczos step.
        av = spmv(matrix, v)
        w = av - beta * v_prev
        alpha = jnp.vdot(v, w)
        w = w - alpha * v
        beta_new = jnp.linalg.norm(w)
        v_next = w / jnp.maximum(beta_new, 1e-30)
        # Two previous Givens rotations applied to the new column.
        delta = g1 * alpha - g0 * s1 * beta
        rho1 = jnp.sqrt(delta * delta + beta_new * beta_new)
        rho2 = s1 * alpha + g0 * g1 * beta
        rho3 = s0 * beta
        # New rotation annihilating beta_new.
        g_new = delta / jnp.maximum(rho1, 1e-30)
        s_new = beta_new / jnp.maximum(rho1, 1e-30)
        w_new = (v - rho3 * w2 - rho2 * w1) / jnp.maximum(rho1, 1e-30)
        x = x + g_new * eta * w_new
        eta_new = -s_new * eta
        carry = (
            x, v, v_next, beta_new, eta_new,
            g1, g_new, s1, s_new, w1, w_new,
        )
        return carry, jnp.abs(eta_new)

    one = jnp.asarray(1.0, b.dtype)
    snil = jnp.asarray(0.0, b.dtype)
    carry0 = (x, zero, v, snil, beta1, one, one, snil, snil, zero, zero)
    if tol is not None:
        return _while_solve(
            lambda c: step(c, None), carry0, b, num_iters, tol
        )
    (x, *_), res_norms = jax.lax.scan(step, carry0, None, length=num_iters)
    return x, res_norms


def lanczos_eigsh(
    matrix,
    v0: jax.Array,
    num_iters: int = 30,
    k: int = 4,
    spmv: Callable = spmv_csr,
):
    """Extremal eigenvalues of symmetric A via Lanczos + tridiagonal solve.

    Runs :func:`lanczos` on device, then solves the small (num_iters,
    num_iters) tridiagonal eigenproblem host-side. Returns (lows, highs):
    the ``k`` smallest and ``k`` largest Ritz values — e.g. spectrum
    bounds for :func:`chebyshev` (pad by a few percent for safety).
    Single-pass Lanczos without reorthogonalization: extremal Ritz values
    converge first and are the trustworthy ones.
    """
    import numpy as np

    alphas, betas, _ = lanczos(matrix, v0, num_iters=num_iters, spmv=spmv)
    a = np.asarray(alphas, dtype=np.float64)
    bt = np.asarray(betas, dtype=np.float64)[:-1]
    try:
        from scipy.linalg import eigh_tridiagonal

        ritz = eigh_tridiagonal(a, bt, eigvals_only=True)
    except ImportError:  # pragma: no cover — scipy is normally present
        t = np.diag(a) + np.diag(bt, 1) + np.diag(bt, -1)
        ritz = np.linalg.eigvalsh(t)
    k = min(k, len(ritz))
    return ritz[:k], ritz[-k:]


def lobpcg(
    matrix,
    X0: jax.Array,
    num_iters: int = 40,
    *,
    m: Optional[Callable] = None,
    spmm: Optional[Callable] = None,
    largest: bool = False,
):
    """LOBPCG: k extremal eigenpairs of symmetric A, preconditioned.

    Locally-optimal block preconditioned CG (Knyazev) — THE eigensolver
    shape for this engine: the per-step work is two SpMMs over the
    (n, k) block (any k-wide SpMM via ``spmm=``), one tall-skinny
    QR and one (3k, 3k) dense eigenproblem, and the optional
    preconditioner ``m`` (e.g. :func:`amg_preconditioner` — AMG turns
    the smallest-eigenpair problem grid-independent exactly as it does
    linear solves). Runs a fixed ``num_iters`` under ``lax.scan``.

    ``X0`` is the (n, k) initial block (random is fine). ``m`` follows
    the pcg factory contract (residual vector → preconditioned image);
    appliers that declare ``m.supports_block = True`` (the AMG factory)
    receive the whole (n, k) residual block in ONE call — the V-cycle
    then runs k-wide on SpMMs — while vector-only factories are
    applied per column. Returns
    ``(theta, X, res)``: Ritz values (k,) ascending (descending for
    ``largest=True``), eigenvector block (n, k), per-iteration residual
    norms (num_iters, k).
    """
    if spmm is None:
        from smvp_toolkit_tpu.ops.spmv_xla import spmm_csr as _spmm

        spmm = _spmm
    n, k = X0.shape

    def a_mul(X):
        return spmm(matrix, X)

    m_mul = lambda R: _precond_block(m, R)  # noqa: E731

    X0 = X0.astype(jnp.float32)
    q0, _ = jnp.linalg.qr(X0)
    theta0 = jnp.sum(q0 * a_mul(q0), axis=0)
    # P starts as a random block independent of X: the first Rayleigh-
    # Ritz then searches span[X, W, P] at full rank (a zero P would make
    # the QR basis arbitrary in its trailing columns).
    p0 = jnp.linalg.qr(
        jax.random.normal(jax.random.PRNGKey(7), (n, k), jnp.float32)
    )[0]

    def step(carry, _):
        X, P, theta = carry
        AX = a_mul(X)
        R = AX - X * theta[None, :]
        res = jnp.linalg.norm(R, axis=0)
        W = m_mul(R)
        S = jnp.concatenate([X, W, P], axis=1)  # (n, 3k)
        Q, _ = jnp.linalg.qr(S)
        AQ = a_mul(Q)
        T = _mm(Q.T, AQ)
        T = (T + T.T) * 0.5
        evals, C = jnp.linalg.eigh(T)  # ascending
        Ck = C[:, -k:][:, ::-1] if largest else C[:, :k]
        thetan = (evals[-k:][::-1] if largest else evals[:k])
        Xn = _mm(Q, Ck)
        # The locally-optimal direction: the W/P contribution to the new
        # block, renormalized so the next basis stays well-conditioned.
        Pn = _mm(Q[:, k:], Ck[k:, :])
        Pn = Pn / (jnp.linalg.norm(Pn, axis=0, keepdims=True) + 1e-30)
        return (Xn, Pn, thetan), res

    (X, _, theta), res = jax.lax.scan(
        step, (q0, p0, theta0), None, length=num_iters
    )
    return theta, X, res


def gmres(
    matrix,
    b: jax.Array,
    x0: Optional[jax.Array] = None,
    restart: int = 20,
    num_restarts: int = 5,
    spmv: Callable = spmv_csr,
    tol: Optional[float] = None,
):
    """Solve A x = b for general (nonsymmetric) A by restarted GMRES(m).

    Arnoldi with modified Gram-Schmidt under ``lax.scan`` (static m =
    ``restart``); the small (m+1, m) least-squares solve runs as a dense
    QR on device. Returns (x, residual_norm_per_restart).

    ``tol``: optional relative-residual target checked at RESTART
    boundaries (the natural synchronization points — each on-device
    check saves a whole m-SpMV Arnoldi cycle once converged), via the
    same ``lax.while_loop`` machinery as the CG family.

    Structure notes: the Krylov basis is a static (m+1, n) array
    updated with ``dynamic_update_slice`` — no Python-level growth; all
    inner products are fused reductions.
    """
    n = b.shape[0]
    m = restart
    x = jnp.zeros_like(b) if x0 is None else x0

    def arnoldi_cycle(x, _):
        r = b - spmv(matrix, x)
        beta = jnp.linalg.norm(r)
        v0 = r / jnp.maximum(beta, 1e-30)
        V = jnp.zeros((m + 1, n), b.dtype).at[0].set(v0)
        H = jnp.zeros((m + 1, m), b.dtype)

        def arnoldi_step(carry, j):
            V, H = carry
            w = spmv(matrix, V[j])
            wnorm = jnp.linalg.norm(w)

            # Modified Gram-Schmidt against all m+1 rows; rows > j are
            # zero so the masked projections are no-ops (static shapes).
            def mgs(w, i):
                h = jnp.where(i <= j, jnp.vdot(V[i], w), 0.0)
                return w - h * V[i], h

            w, hcol = jax.lax.scan(mgs, w, jnp.arange(m + 1))
            hnorm = jnp.linalg.norm(w)
            # Lucky breakdown (the Krylov space is invariant, e.g. once
            # m exceeds n): what is left of w is rounding noise. Extend
            # the basis with zeros instead of normalized noise, which
            # would corrupt the least-squares solve.
            live = hnorm > 64 * jnp.finfo(b.dtype).eps * wnorm
            hnorm = jnp.where(live, hnorm, 0.0)
            hcol = hcol.at[j + 1].set(hnorm)
            V = V.at[j + 1].set(
                jnp.where(live, w / jnp.maximum(hnorm, 1e-30), 0.0))
            H = H.at[:, j].set(hcol)
            return (V, H), None

        (V, H), _ = jax.lax.scan(
            arnoldi_step, (V, H), jnp.arange(m)
        )
        # Least squares min ||beta e1 - H y|| via dense QR (m is small).
        e1 = jnp.zeros((m + 1,), b.dtype).at[0].set(beta)
        y, *_ = jnp.linalg.lstsq(H, e1, rcond=None)
        x = x + _mm(V[:m].T, y)
        res = jnp.linalg.norm(b - spmv(matrix, x))
        return x, res

    if tol is not None:
        def cycle_step(carry):
            (x,) = carry
            x, res = arnoldi_cycle(x, None)
            return (x,), res

        return _while_solve(cycle_step, (x,), b, num_restarts, tol)
    x, res_norms = jax.lax.scan(arnoldi_cycle, x, None, length=num_restarts)
    return x, res_norms


def pcg(
    matrix,
    b: jax.Array,
    diag: jax.Array,
    x0: Optional[jax.Array] = None,
    num_iters: int = 50,
    spmv: Callable = spmv_csr,
    tol: Optional[float] = None,
):
    """Jacobi-preconditioned CG: M = diag(A) (SPD systems).

    The cheapest preconditioner that still collapses condition numbers
    of diagonally-dominant systems; the preconditioner apply is one VPU
    multiply per step. Returns (x, residual_norms). One CG recurrence
    lives in the codebase: this delegates to :func:`pcg_precond` with
    ``z = D⁻¹ r``.
    """
    inv_d = 1.0 / jnp.where(jnp.abs(diag) > 1e-30, diag, 1.0)
    return pcg_precond(
        matrix, b, lambda r: inv_d * r, x0=x0, num_iters=num_iters,
        spmv=spmv, tol=tol,
    )


def jacobi_preconditioner(
    matrix, diag: jax.Array, order: int = 3, spmv: Callable = spmv_csr
) -> Callable:
    """Truncated-Neumann (fixed-count Jacobi) preconditioner factory.

    ``apply(r) = M⁻¹r`` with ``M⁻¹ = Σ_{k<order} (I − D⁻¹A)^k D⁻¹`` —
    ``order`` Jacobi sweeps from zero. The sweep count is FIXED, so the
    operator is the same linear polynomial on every apply (a CG
    preconditioner must be a constant SPD operator). Each apply costs
    ``order`` SpMVs and zero reductions — it shifts work from CG's
    latency-bound all-reduce dot products onto the bandwidth-bound SpMV,
    the right trade on a sharded mesh. ``order=1`` is plain Jacobi
    scaling (what :func:`pcg` builds in).

    Use an ODD order: ``p(t) = Σ_{k<order} (1−t)^k`` is positive for
    all t > 0 only when the order is odd. Even orders give p(t) < 0
    wherever λ(D⁻¹A) exceeds a root (order 2: λ > 2 — any SPD system
    that is not diagonally dominant), making M⁻¹ indefinite and CG
    silently stall.
    """
    if order % 2 == 0:
        import warnings

        warnings.warn(
            "jacobi_preconditioner: even order gives an indefinite "
            "preconditioner whenever lambda_max(D^-1 A) exceeds a root "
            "of the Neumann polynomial (order 2: >2); use an odd order "
            "unless the system is diagonally dominant",
            stacklevel=2,
        )

    def apply(r: jax.Array) -> jax.Array:
        return jacobi(matrix, r, diag, num_iters=order, spmv=spmv)

    return apply


def chebyshev_preconditioner(
    matrix,
    lambda_min: float,
    lambda_max: float,
    degree: int = 4,
    spmv: Callable = spmv_csr,
) -> Callable:
    """Chebyshev polynomial preconditioner factory (SPD spectrum bounds).

    A fixed-degree Chebyshev semi-iteration approximating ``A⁻¹`` on
    ``[lambda_min, lambda_max]`` — the minimax-optimal polynomial of
    that degree, inner-product-free (``degree`` SpMVs + AXPYs per
    apply, zero global reductions): the classic communication-avoiding
    preconditioner for distributed CG. Spectrum bounds can come from a
    few :func:`lanczos_eigsh` iterations. Fixed degree ⇒ constant
    linear operator, as CG requires.
    """

    def apply(r: jax.Array) -> jax.Array:
        z, _ = chebyshev(
            matrix, r, lambda_min, lambda_max, num_iters=degree,
            spmv=spmv,
        )
        return z

    return apply


def pcg_precond(
    matrix,
    b: jax.Array,
    precond: Callable,
    x0: Optional[jax.Array] = None,
    num_iters: int = 50,
    spmv: Callable = spmv_csr,
    tol: Optional[float] = None,
):
    """CG with a general preconditioner callable ``z = precond(r)``.

    ``precond`` must apply a CONSTANT SPD operator (Jacobi scaling, the
    polynomial factories above, or any user-supplied M⁻¹); CG's
    three-term recurrence silently loses orthogonality otherwise.
    Returns (x, residual_norms). ``tol`` enables on-device early
    stopping exactly as in :func:`conjugate_gradient`.
    """
    x = jnp.zeros_like(b) if x0 is None else x0
    r = b - spmv(matrix, x)
    z = precond(r)
    p = z
    rz = jnp.vdot(r, z)

    def step(carry):
        x, r, z, p, rz = carry
        ap = spmv(matrix, p)
        alpha = rz / jnp.maximum(jnp.vdot(p, ap), 1e-30)
        x = x + alpha * p
        r = r - alpha * ap
        z = precond(r)
        rz_new = jnp.vdot(r, z)
        beta = rz_new / jnp.maximum(rz, 1e-30)
        p = z + beta * p
        return (x, r, z, p, rz_new), jnp.linalg.norm(r)

    if tol is None:
        (x, *_), res = jax.lax.scan(
            lambda c, _: step(c), (x, r, z, p, rz), None,
            length=num_iters,
        )
        return x, res
    return _while_solve(step, (x, r, z, p, rz), b, num_iters, tol)


def ic0_preconditioner(
    factors,
    sweeps: int = 4,
    spmv: Callable = spmv_csr,
    op_builder: Optional[Callable] = None,
) -> Callable:
    """IC(0) preconditioner factory: ``apply(r) ≈ (L·Lᵀ)⁻¹ r``.

    ``factors`` comes from :func:`~smvp_toolkit_tpu.ops.ilu.ic0`
    (host-side, encode-time). The apply is two fixed-sweep
    truncated-Neumann triangular solves (``ops/ilu.py``) — pure
    SpMV + elementwise multiplies with a static trip count, the
    data-parallel replacement for sequential forward/back substitution. Because both
    solves use the SAME sweep count, the composite is exactly
    ``P_Lᵀ·P_L``: symmetric positive definite for every ``sweeps``
    value, so the inexact apply is rigorously CG-safe (a constant SPD
    operator, as :func:`pcg_precond` requires).

    ``sweeps`` trades apply cost (2·sweeps SpMVs on the half-pattern
    factors) against preconditioner strength; 3-5 is the usual sweet
    spot (Chow & Patel-style inexact-apply practice).

    ``op_builder`` puts the trisolves on a kernel's performance path:
    it receives each concrete factor ``CSRMatrix`` once at factory time
    and returns a closure ``op(x)`` (e.g. a row-block sharded SpMV over
    a ``shard_csr`` of the factor — sharding happens host-side, so
    building here keeps the solver jittable).
    """
    from smvp_toolkit_tpu.ops.ilu import trisolve_neumann

    spmv_l = spmv_lt = spmv
    if op_builder is not None:
        op_l, op_lt = op_builder(factors.strict), op_builder(factors.strict_t)
        spmv_l = lambda _m, z: op_l(z)  # noqa: E731
        spmv_lt = lambda _m, z: op_lt(z)  # noqa: E731

    def apply(r: jax.Array) -> jax.Array:
        z = trisolve_neumann(
            factors.strict, factors.diag, r, sweeps=sweeps, spmv=spmv_l
        )
        return trisolve_neumann(
            factors.strict_t, factors.diag, z, sweeps=sweeps, spmv=spmv_lt
        )

    return apply


def ilu_preconditioner(
    factors,
    sweeps: int = 4,
    spmv: Callable = spmv_csr,
    op_builder: Optional[Callable] = None,
) -> Callable:
    """ILU(0) preconditioner factory: ``apply(r) ≈ (L·U)⁻¹ r``.

    ``factors`` comes from :func:`~smvp_toolkit_tpu.ops.ilu.ilu0`.
    For GENERAL square systems — pair it with :func:`bicgstab` or
    :func:`gmres` (the composite polynomial apply is not symmetric, so
    it is not a CG preconditioner; use :func:`ic0_preconditioner` for
    SPD systems). Both triangular solves are fixed-sweep
    truncated-Neumann applies (exact once ``sweeps`` exceeds each
    factor's nilpotency index). ``op_builder`` — see
    :func:`ic0_preconditioner` (performance-path trisolves).
    """
    from smvp_toolkit_tpu.ops.ilu import trisolve_neumann

    spmv_l = spmv_u = spmv
    if op_builder is not None:
        op_l, op_u = op_builder(factors.l_strict), op_builder(factors.u_strict)
        spmv_l = lambda _m, z: op_l(z)  # noqa: E731
        spmv_u = lambda _m, z: op_u(z)  # noqa: E731

    def apply(r: jax.Array) -> jax.Array:
        z = trisolve_neumann(
            factors.l_strict, None, r, sweeps=sweeps, spmv=spmv_l
        )
        return trisolve_neumann(
            factors.u_strict, factors.u_diag, z, sweeps=sweeps, spmv=spmv_u
        )

    return apply


def ssor_preconditioner(
    matrix,
    omega: float = 1.0,
    sweeps: int = 4,
    op_builder: Optional[Callable] = None,
    spmv: Callable = spmv_csr,
) -> Callable:
    """SSOR preconditioner factory: ``M = (D+ωL)D⁻¹(D+ωU)/(ω(2−ω))``.

    The zero-setup member of the preconditioner family: no
    factorization at all — the triangular parts ARE submatrices of A
    (``ops.ilu.split_triangular``), so the factory costs one host-side
    split. The apply is the same fixed-sweep truncated-Neumann
    triangular machinery as :func:`ic0_preconditioner`; for symmetric
    A (``U = Lᵀ``) with equal sweep counts the composite is exactly
    ``c·P_Lᵀ·D·P_L`` — symmetric, and PD whenever diag(A) > 0 — so the
    inexact apply is CG-safe at any sweep count. ``omega`` in (0, 2);
    ``omega=1`` is symmetric Gauss-Seidel.

    Weaker than IC(0) per iteration but with no breakdown modes and no
    factorization time: the right first reach for very large or
    frequently-changing operators.
    """
    if not 0.0 < omega < 2.0:
        raise ValueError(f"ssor needs 0 < omega < 2, got {omega}")
    import dataclasses as _dc

    from smvp_toolkit_tpu.ops.ilu import split_triangular, trisolve_neumann

    low, d, up = split_triangular(matrix)
    if omega != 1.0:
        low = _dc.replace(low, vals=low.vals * omega)
        up = _dc.replace(up, vals=up.vals * omega)
    # Zero/near-zero diagonal entries would make the Jacobi sweeps
    # divide by zero; patch them to 1 (identity row in M), same guard
    # as pcg's Jacobi scaling.
    d = jnp.where(jnp.abs(d) > 1e-30, d, jnp.ones_like(d))
    scale = omega * (2.0 - omega)

    spmv_l = spmv_u = spmv
    if op_builder is not None:
        op_l, op_u = op_builder(low), op_builder(up)
        spmv_l = lambda _m, z: op_l(z)  # noqa: E731
        spmv_u = lambda _m, z: op_u(z)  # noqa: E731

    def apply(r: jax.Array) -> jax.Array:
        y = trisolve_neumann(low, d, r, sweeps=sweeps, spmv=spmv_l)
        w = trisolve_neumann(up, d, d * y, sweeps=sweeps, spmv=spmv_u)
        return scale * w

    return apply


def block_jacobi_preconditioner(
    matrix, block: int = 64
) -> Callable:
    """Block-Jacobi factory: ``M = blockdiag(A₁₁, A₂₂, …)``, blocks dense.

    The matmul-shaped member of the preconditioner family: the diagonal
    blocks are extracted host-side (encode-time, like the other
    factories), inverted ONCE as a batched dense ``(nb, block, block)``
    ``jnp.linalg.inv`` — regular, dense work — and every apply is a
    single batched mat-vec, no
    sweeps, no sparsity, no gather. For symmetric A each block (hence
    its inverse) is symmetric, so the apply is a constant symmetric
    operator — CG-safe whenever the blocks are PD (any SPD A).

    Captures geometry the pointwise Jacobi misses (``block`` spanning a
    grid line gives classic line relaxation); costs O(block²) memory
    per block-row. Rows with no entries inside their diagonal block
    (padding rows, structurally missing diagonals) become identity
    rows; numerically singular blocks — and ONLY those blocks — are
    ridged (escalating diagonal shift, same policy as the ILU shift
    ladder) until their inverse is finite.
    """
    import warnings

    import numpy as np

    from smvp_toolkit_tpu.ops.ilu import _csr_host

    n, m = matrix.shape
    if n != m:
        raise ValueError(
            f"block_jacobi needs a square matrix, got {matrix.shape}"
        )
    if block < 1:
        raise ValueError(f"block must be positive, got {block}")
    block = min(block, n)
    rp, ci, v = _csr_host(matrix)
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(rp[: n + 1]))
    nb = -(-n // block)
    blocks = np.zeros((nb, block, block), np.float64)
    same = (rows // block) == (ci // block)
    blocks[rows[same] // block, rows[same] % block, ci[same] % block] = (
        v[same]
    )
    # Rows with no entries inside their diagonal block — padding rows
    # of the last block and real rows whose diagonal is structurally
    # missing — become identity rows: the block inverse acts as the
    # identity there instead of tripping the ridge ladder below.
    empty_r, empty_c = np.nonzero(~blocks.any(axis=2))
    blocks[empty_r, empty_c, empty_c] = 1.0

    scale = float(np.max(np.abs(v))) if v.size else 1.0
    eye = np.eye(block)

    def _inv(bl):
        try:
            with np.errstate(all="ignore"):
                cand = np.linalg.inv(bl)
        except np.linalg.LinAlgError:
            return None
        return cand if np.isfinite(cand).all() else None

    binv = _inv(blocks)
    if binv is None:
        # Ridge ONLY the singular blocks (escalating diagonal shift,
        # same policy as the ILU shift ladder); healthy blocks keep
        # their exact inverses.
        binv = np.empty_like(blocks)
        bad = []
        for bi in range(nb):
            inv_b = _inv(blocks[bi])
            if inv_b is None:
                bad.append(bi)
            else:
                binv[bi] = inv_b
        max_ridge = 0.0
        for bi in bad:
            ridge, inv_b = scale * 1e-6, None
            for _ in range(9):
                inv_b = _inv(blocks[bi] + ridge * eye)
                if inv_b is not None:
                    break
                ridge *= 10.0
            if inv_b is None:
                raise ValueError(
                    "block_jacobi: a diagonal block remained singular "
                    "under the ridge ladder — the diagonal blocks of "
                    "this matrix are degenerate"
                )
            binv[bi] = inv_b
            max_ridge = max(max_ridge, ridge)
        warnings.warn(
            f"block_jacobi: {len(bad)} singular diagonal block(s); "
            f"ridged with up to {max_ridge:g} to invert — the "
            "preconditioner is weakened on those blocks only",
            stacklevel=2,
        )
    dtype = matrix.vals.dtype
    binv_dev = jnp.asarray(binv, dtype)
    pad = nb * block - n

    def apply(r: jax.Array) -> jax.Array:
        rb = jnp.pad(r, (0, pad)).reshape(nb, block)
        y = jnp.einsum("nij,nj->ni", binv_dev, rb, precision=_HIGHEST)
        return y.reshape(-1)[:n]

    return apply
