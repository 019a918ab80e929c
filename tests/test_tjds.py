"""TJDS codec tests: correct encode (vs reference §B2-§B4 bugs), decode
bit-exactness, SpMV with *general* x vectors, property tests.

Per SURVEY.md §4: the reference's own TJDS golden vectors are corrupted
(diagonal-count bug main-cli.c:865), so TJDS is validated against math
(dense oracle + CSR cross-check), never against the reference TJDS output.
"""

import os

import numpy as np
import pytest

from smvp_toolkit_tpu.formats.coo import COOMatrix
from smvp_toolkit_tpu.formats.csr import csr_encode
from smvp_toolkit_tpu.formats.tjds import tjds_encode, tjds_decode
from smvp_toolkit_tpu.io.mtx import read_mtx
from smvp_toolkit_tpu.ops import spmv_csr, spmv_tjds

from conftest import SAMPLE_DIR, SAMPLES_SMALL, random_coo


def _load(name, pad=128):
    coo = read_mtx(os.path.join(SAMPLE_DIR, name), use_native=False)
    return coo.pad(pad)


@pytest.mark.parametrize("name", SAMPLES_SMALL)
def test_spmv_ones_matches_dense(name):
    # x = ones: the only vector the reference ever uses (main-cli.c:761-762).
    coo = _load(name)
    tj = tjds_encode(coo)
    x = np.ones(coo.shape[1], dtype=np.float32)
    y = np.asarray(spmv_tjds(tj, np.asarray(x)))
    y_ref = coo.to_dense() @ x.astype(np.float64)
    np.testing.assert_allclose(y, y_ref, rtol=1e-5)


@pytest.mark.parametrize("name", SAMPLES_SMALL)
def test_spmv_general_x(name):
    # General x exposes the reference's §B4 x-indexing bug; ours must pass.
    coo = _load(name)
    tj = tjds_encode(coo)
    rng = np.random.RandomState(7)
    x = rng.randn(coo.shape[1]).astype(np.float32)
    y = np.asarray(spmv_tjds(tj, np.asarray(x)))
    y_ref = coo.to_dense() @ x.astype(np.float64)
    np.testing.assert_allclose(y, y_ref, rtol=2e-4, atol=1e-5)


def test_curtis54_all_diagonals_computed():
    # Reference bug §B2 verified on curtis54: it computes only 4 of 16
    # diagonals (Σy = 205 instead of 291). Correct TJDS computes every
    # diagonal — as many as the longest column has entries — and, on a
    # pattern matrix with x = ones, gives Σy = nnz = 291.
    coo = _load("curtis54.mtx")
    tj = tjds_encode(coo)
    _, cols, _ = coo.to_numpy()
    assert int(tj.num_diags) == np.bincount(cols).max()
    x = np.ones(coo.shape[1], dtype=np.float32)
    y = np.asarray(spmv_tjds(tj, np.asarray(x)))
    assert y.sum() == 291.0


@pytest.mark.parametrize("name", SAMPLES_SMALL)
def test_cross_check_vs_csr(name):
    coo = _load(name)
    tj = tjds_encode(coo)
    csr = csr_encode(coo)
    rng = np.random.RandomState(1)
    x = np.asarray(rng.randn(coo.shape[1]), dtype=np.float32)
    y1 = np.asarray(spmv_tjds(tj, x))
    y2 = np.asarray(spmv_csr(csr, x))
    np.testing.assert_allclose(y1, y2, rtol=2e-4, atol=1e-5)


@pytest.mark.parametrize("name", SAMPLES_SMALL)
def test_decode_bit_exact(name):
    coo = _load(name)
    tj = tjds_encode(coo)
    dec = tjds_decode(tj).canonical_order()
    canon = coo.canonical_order()
    r, c, v = dec.to_numpy()
    R, C, V = canon.to_numpy()
    np.testing.assert_array_equal(r, R)
    np.testing.assert_array_equal(c, C)
    np.testing.assert_array_equal(
        np.asarray(v).view(np.uint32), np.asarray(V).view(np.uint32)
    )


def test_structure_invariants():
    coo = _load("curtis54.mtx")
    tj = tjds_encode(coo)
    sp = np.asarray(tj.start_pos)
    nd = int(tj.num_diags)
    # start_pos non-decreasing, starts at 0, saturates at nnz after num_diags.
    assert sp[0] == 0
    assert (np.diff(sp) >= 0).all()
    assert (sp[nd:] == tj.nnz).all()
    # Diagonal segment lengths are non-increasing (jagged property).
    seg = np.diff(sp[: nd + 1])
    assert (np.diff(seg) <= 0).all()
    # Permutation is a permutation.
    perm = np.asarray(tj.perm)
    assert sorted(perm.tolist()) == list(range(coo.shape[1]))
    # Offsets within each diagonal are 0..len-1 (contiguous x reads).
    offs = np.asarray(tj.offsets)
    for d in range(nd):
        lo, hi = sp[d], sp[d + 1]
        np.testing.assert_array_equal(offs[lo:hi], np.arange(hi - lo))


def test_column_permutation_descending_length():
    coo = _load("curtis54.mtx")
    tj = tjds_encode(coo)
    r, c, v = coo.to_numpy()
    counts = np.bincount(c, minlength=coo.shape[1])
    perm = np.asarray(tj.perm)
    lens = counts[perm]
    assert (np.diff(lens) <= 0).all()
    assert int(tj.num_diags) == counts.max()


@pytest.mark.parametrize("seed", range(5))
def test_property_random_patterns(seed):
    rng = np.random.RandomState(100 + seed)
    nrows = rng.randint(1, 50)
    ncols = rng.randint(1, 50)
    nnz = rng.randint(1, max(2, nrows * ncols // 2))
    r, c, v = random_coo(rng, nrows, ncols, nnz)
    coo = COOMatrix.from_numpy(r, c, v, shape=(nrows, ncols), pad_to=64)
    tj = tjds_encode(coo)
    # Decode round trip.
    dec = tjds_decode(tj).canonical_order().to_numpy()
    canon = coo.canonical_order().to_numpy()
    for a, b in zip(dec, canon):
        np.testing.assert_array_equal(a, b)
    # SpMV vs dense oracle.
    x = np.asarray(rng.randn(ncols), dtype=np.float32)
    y = np.asarray(spmv_tjds(tj, x))
    y_ref = coo.to_dense() @ x.astype(np.float64)
    np.testing.assert_allclose(y, y_ref, rtol=2e-4, atol=1e-5)


def test_empty_columns():
    # Columns with no entries must not break the permutation or pack.
    r = np.array([0, 1, 2], dtype=np.int32)
    c = np.array([4, 4, 4], dtype=np.int32)
    v = np.array([1.0, 2.0, 3.0])
    coo = COOMatrix.from_numpy(r, c, v, shape=(3, 6), pad_to=8)
    tj = tjds_encode(coo)
    assert int(tj.num_diags) == 3
    x = np.arange(6, dtype=np.float32)
    y = np.asarray(spmv_tjds(tj, x))
    np.testing.assert_allclose(y, coo.to_dense() @ x.astype(np.float64))


def test_footprint_accounting():
    coo = _load("curtis54.mtx")
    tj = tjds_encode(coo)
    nd = int(tj.num_diags)
    expected = 291 * (4 + 4) + (nd + 1) * 4 + 54 * 4
    assert tj.footprint_bytes() == expected


def test_start_pos_is_o_num_diags():
    """start_pos must be sized by the diagonal count, not padded nnz
    (round-1 finding: diag_bound = npad made it O(nnz_padded))."""
    import numpy as np

    from smvp_toolkit_tpu.formats.coo import COOMatrix
    from smvp_toolkit_tpu.formats.tjds import tjds_encode

    rng = np.random.default_rng(7)
    n = 200
    nnz = 2000
    r = rng.integers(0, n, nnz)
    c = rng.integers(0, n, nnz)
    v = rng.standard_normal(nnz)
    coo = COOMatrix.from_numpy(r, c, v, shape=(n, n)).pad(256)
    tj = tjds_encode(coo)
    nd = int(tj.num_diags)
    assert tj.start_pos.shape[0] <= -(-nd // 8) * 8 + 1
    assert tj.start_pos.shape[0] < coo.nnz_padded // 2


def test_tjds_duplicates_roundtrip():
    """Duplicate (row, col) entries survive encode/decode and make
    column lengths exceed nrows without breaking the diagonal bound."""
    import numpy as np

    from smvp_toolkit_tpu.formats.coo import COOMatrix
    from smvp_toolkit_tpu.formats.tjds import tjds_decode, tjds_encode

    r = np.array([0, 0, 0, 0, 1, 2], dtype=np.int32)
    c = np.array([1, 1, 1, 1, 1, 0], dtype=np.int32)
    v = np.array([1.0, 2.0, 3.0, 4.0, 5.0, 6.0])
    coo = COOMatrix.from_numpy(r, c, v, shape=(3, 3)).pad(8)
    tj = tjds_encode(coo)
    assert int(tj.num_diags) == 5  # column 1 holds 5 entries > nrows
    back = tjds_decode(tj).canonical_order()
    ref = coo.canonical_order()
    br, bc, bv = back.to_numpy()
    rr, rc, rv = ref.to_numpy()
    np.testing.assert_array_equal(br, rr)
    np.testing.assert_array_equal(bc, rc)
    np.testing.assert_allclose(np.sort(bv), np.sort(rv))
