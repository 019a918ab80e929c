"""Native encode fast path: bit-identical to the XLA encoders.

``native/encode.cpp`` replaces the encode-time device lexsorts with
stable counting sorts on the host. Because both sides implement the same
stable (key-chain) sort over the same sentinel-forced triplets, every
output array must be *exactly* equal — dtype and value — not just
numerically close. These tests prove it per array, per format, across
the reference samples and adversarial structures (duplicates, empty
rows/columns, rectangular shapes, empty matrices, complex values).
"""

import os

import numpy as np
import pytest

from smvp_toolkit_tpu.formats import encode_native as en
from smvp_toolkit_tpu.formats.coo import COOMatrix
from smvp_toolkit_tpu.formats.csr import _csr_encode_impl, csr_encode
from smvp_toolkit_tpu.formats.tjds import (
    _max_col_count,
    _tjds_encode_impl,
    tjds_encode,
)
from smvp_toolkit_tpu.io.mtx import read_mtx

from conftest import SAMPLE_DIR

pytestmark = pytest.mark.skipif(
    en._lib() is None, reason="libencode.so not built"
)

SAMPLES = ["ibm32", "curtis54", "pdp08-pg4", "memplus"]


def _assert_csr_equal(coo):
    assert en.use_native(coo)
    native = csr_encode(coo)
    xla = _csr_encode_impl(coo, with_row_ids=True)
    for field in ("row_ptr", "col_ind", "vals", "row_ids"):
        a = np.asarray(getattr(native, field))
        b = np.asarray(getattr(xla, field))
        assert a.dtype == b.dtype, field
        assert np.array_equal(a, b), field
    assert native.shape == xla.shape and native.nnz == xla.nnz


def _assert_tjds_equal(coo):
    assert en.use_native(coo)
    native = tjds_encode(coo)
    nd = _max_col_count(coo)
    xla = _tjds_encode_impl(coo, max(-(-nd // 8) * 8, 8))
    for field in (
        "vals", "row_ind", "start_pos", "perm", "offsets", "num_diags",
    ):
        a = np.asarray(getattr(native, field))
        b = np.asarray(getattr(xla, field))
        assert a.dtype == b.dtype, field
        assert np.array_equal(a, b), field
    assert native.shape == xla.shape and native.nnz == xla.nnz


@pytest.mark.parametrize("name", SAMPLES)
def test_samples_bit_identical(name):
    coo = read_mtx(os.path.join(SAMPLE_DIR, f"{name}.mtx")).pad(512)
    _assert_csr_equal(coo)
    _assert_tjds_equal(coo)


def test_random_duplicates_rectangular():
    rng = np.random.default_rng(7)
    r = rng.integers(0, 50, 400)
    c = rng.integers(0, 37, 400)
    v = rng.normal(size=400)
    coo = COOMatrix.from_numpy(r, c, v, shape=(60, 40), pad_to=128)
    _assert_csr_equal(coo)
    _assert_tjds_equal(coo)


def test_wide_rectangular():
    rng = np.random.default_rng(8)
    r = rng.integers(0, 12, 300)
    c = rng.integers(0, 500, 300)
    v = rng.normal(size=300)
    coo = COOMatrix.from_numpy(r, c, v, shape=(12, 512), pad_to=512)
    _assert_csr_equal(coo)
    _assert_tjds_equal(coo)


def test_empty_matrix():
    z = np.array([], dtype=np.int32)
    coo = COOMatrix.from_numpy(
        z, z, np.array([], dtype=np.float32), shape=(5, 7), pad_to=64
    )
    _assert_csr_equal(coo)
    _assert_tjds_equal(coo)


def test_complex_values():
    rng = np.random.default_rng(9)
    r = rng.integers(0, 20, 100)
    c = rng.integers(0, 20, 100)
    v = rng.normal(size=100) + 1j * rng.normal(size=100)
    coo = COOMatrix.from_numpy(
        r, c, v, shape=(20, 20), dtype="complex64", pad_to=128
    )
    _assert_csr_equal(coo)
    _assert_tjds_equal(coo)


def test_single_dense_column():
    # One column owns every entry: num_diags == nnz stresses the
    # diagonal bucketing and start_pos sizing.
    n = 40
    r = np.arange(n)
    c = np.zeros(n, dtype=np.int64)
    v = np.linspace(1.0, 2.0, n)
    coo = COOMatrix.from_numpy(r, c, v, shape=(n, 8), pad_to=64)
    _assert_csr_equal(coo)
    _assert_tjds_equal(coo)


def test_env_disable(monkeypatch):
    coo = read_mtx(os.path.join(SAMPLE_DIR, "ibm32.mtx")).pad(512)
    monkeypatch.setenv("SMVP_NATIVE_ENCODE", "0")
    assert not en.use_native(coo)


def test_traced_values_fall_back_to_xla():
    import jax

    coo = read_mtx(os.path.join(SAMPLE_DIR, "ibm32.mtx")).pad(512)

    @jax.jit
    def encode_sum(c):
        assert not en.use_native(c)  # traced → must not pull to host
        return csr_encode(c).vals.sum()

    total = float(encode_sum(coo))
    assert np.isclose(total, float(np.asarray(coo.vals).sum()))
