"""SpMV kernel tests: all XLA variants vs dense oracle, all sample matrices,
plus the CSR output vectors of the reference's golden runs, now checked
against a float64 scipy product of the generated stand-in matrices (the
reference's reports and matrices are not distributed with this
repository).
"""

import os

import numpy as np
import pytest

from smvp_toolkit_tpu.formats.csr import csr_encode
from smvp_toolkit_tpu.formats.tjds import tjds_encode
from smvp_toolkit_tpu.io.mtx import read_mtx
from smvp_toolkit_tpu.ops import spmv_coo, spmv_csr, spmv_csr_cumsum, spmv_tjds

from conftest import SAMPLE_DIR, SAMPLES_ALL, SAMPLES_SMALL

# The matrices of the reference's golden CSR reports (SURVEY.md §6).
GOLDEN_CSR = ["ibm32.mtx", "curtis54.mtx", "memplus.mtx", "pwt.mtx"]


def _load(name, pad=128):
    return read_mtx(os.path.join(SAMPLE_DIR, name), use_native=False).pad(pad)


@pytest.mark.parametrize("name", SAMPLES_ALL)
def test_all_kernels_agree_with_oracle(name):
    coo = _load(name)
    dense_y = None
    rng = np.random.RandomState(0)
    x = np.asarray(rng.randn(coo.shape[1]), dtype=np.float32)
    if coo.shape[0] * coo.shape[1] <= 4_000_000:
        dense_y = coo.to_dense() @ x.astype(np.float64)
    else:
        # Dense oracle too large; sparse host oracle instead.
        r, c, v = coo.to_numpy()
        dense_y = np.zeros(coo.shape[0], dtype=np.float64)
        np.add.at(dense_y, r, v.astype(np.float64) * x.astype(np.float64)[c])
    csr = csr_encode(coo)
    tj = tjds_encode(coo)
    ys = {
        "coo": np.asarray(spmv_coo(coo, x)),
        "csr": np.asarray(spmv_csr(csr, x)),
        "csr_cumsum": np.asarray(spmv_csr_cumsum(csr, x)),
        "tjds": np.asarray(spmv_tjds(tj, x)),
    }
    ref = dense_y if dense_y is not None else ys["coo"].astype(np.float64)
    scale = np.abs(ref).max() + 1e-30
    for label, y in ys.items():
        err = np.abs(y.astype(np.float64) - ref).max() / scale
        assert err < 1e-4, (name, label, err)


@pytest.mark.parametrize("name", sorted(GOLDEN_CSR))
def test_golden_csr_vectors(name):
    """The golden runs' protocol (x = ones) against scipy in float64."""
    import scipy.sparse as sp

    coo = _load(name)
    csr = csr_encode(coo)
    x = np.ones(coo.shape[1], dtype=np.float32)
    y = np.asarray(spmv_csr(csr, np.asarray(x))).astype(np.float64)
    r, c, v = coo.to_numpy()
    golden = sp.csr_matrix(
        (v.astype(np.float64), (r, c)), shape=coo.shape
    ) @ np.ones(coo.shape[1])
    assert len(golden) == coo.shape[0]
    # f32 accumulation adds rounding; for rows that cancel to ~0 the
    # honest scale is the row's absolute mass Σ|a_ij|·|x_j|, not the
    # tiny result.
    row_mass = np.zeros(coo.shape[0])
    np.add.at(row_mass, r, np.abs(v))
    tol = 1e-5 * (row_mass + 1e-30) + 1e-6
    assert (np.abs(y - golden) <= tol).all()


def test_zero_matrix():
    from smvp_toolkit_tpu.formats.coo import COOMatrix

    coo = COOMatrix.from_numpy(
        np.zeros(0, np.int32), np.zeros(0, np.int32), np.zeros(0), shape=(4, 4),
        pad_to=8,
    )
    csr = csr_encode(coo)
    x = np.ones(4, dtype=np.float32)
    y = np.asarray(spmv_csr(csr, np.asarray(x)))
    np.testing.assert_array_equal(y, np.zeros(4))


def test_rectangular():
    from smvp_toolkit_tpu.formats.coo import COOMatrix

    rng = np.random.RandomState(5)
    r = np.array([0, 1, 2, 2], dtype=np.int32)
    c = np.array([5, 0, 7, 3], dtype=np.int32)
    v = rng.randn(4)
    coo = COOMatrix.from_numpy(r, c, v, shape=(3, 8), pad_to=8)
    x = np.asarray(rng.randn(8), dtype=np.float32)
    csr = csr_encode(coo)
    tj = tjds_encode(coo)
    ref = coo.to_dense() @ x.astype(np.float64)
    np.testing.assert_allclose(np.asarray(spmv_csr(csr, x)), ref, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(spmv_tjds(tj, x)), ref, rtol=1e-5)


@pytest.mark.parametrize("name", SAMPLES_SMALL)
def test_jit_cache_stable_across_x(name):
    # Same encoded matrix, different x: must not retrace (static shapes).
    import jax

    coo = _load(name)
    csr = csr_encode(coo)
    x1 = np.ones(coo.shape[1], dtype=np.float32)
    x2 = np.full(coo.shape[1], 2.0, dtype=np.float32)
    y1 = spmv_csr(csr, np.asarray(x1))
    y2 = spmv_csr(csr, np.asarray(x2))
    np.testing.assert_allclose(np.asarray(y2), 2 * np.asarray(y1), rtol=1e-6)


def test_complex_matrix_routed_to_xla(tmp_path):
    """Complex matrices must keep their imaginary part: the CLI routes
    them to the XLA kernels even under --kernel native/df64, and the
    CISR schedule kernel stays complex (round-2 fix: f32 casts silently
    dropped imag)."""
    import io as _io

    import jax.numpy as jnp

    from smvp_toolkit_tpu.cli import main as cli_main
    from smvp_toolkit_tpu.formats.cisr import cisr_encode
    from smvp_toolkit_tpu.formats.csr import csr_encode
    from smvp_toolkit_tpu.io.mtx import read_mtx
    from smvp_toolkit_tpu.ops import spmv_cisr

    s = ("%%MatrixMarket matrix coordinate complex general\n2 2 2\n"
         "1 1 1.0 2.0\n2 2 3.0 -1.0\n")
    coo = read_mtx(_io.StringIO(s)).pad(8)

    y = np.asarray(spmv_cisr(cisr_encode(coo), jnp.ones(2, jnp.complex64)))
    np.testing.assert_allclose(y, np.array([1 + 2j, 3 - 1j]), rtol=1e-6)

    p = tmp_path / "cpx.mtx"
    p.write_text(s)
    for kernel in ("native", "df64"):
        rc = cli_main(["-c", "-n", "1", "--kernel", kernel, "--no-report",
                       str(p)])
        assert rc == 0
    # COE packing is real-only: -g on a complex matrix errors cleanly.
    rc = cli_main(["-g", "-n", "1", "--no-report", str(p)])
    assert rc == 1
