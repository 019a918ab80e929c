"""Matrix I/O tests: banner/typecode parsing, loaders, writers, error paths.

Mirrors the reference's manual mmio round-trip tests (mmio-readtest.c /
mmio-writetest.c) as automated pytest cases, plus the badfile.mtx error
fixture (main-cli.c:144-166 error handler path).
"""

import io
import os

import numpy as np
import pytest

from smvp_toolkit_tpu.io.mtx import (
    MMTypeCode,
    MTXError,
    MTXNoHeader,
    MTXPrematureEOF,
    MTXUnsupportedType,
    read_banner,
    read_mtx,
    read_mtx_raw,
    write_mtx,
)

from conftest import SAMPLE_DIR, SAMPLES_ALL

from smvp_toolkit_tpu.utils.synth import sample_triplets


# ---------------------------------------------------------------------------
# Banner / typecode
# ---------------------------------------------------------------------------


def test_banner_parses_all_samples(sample_dir):
    for name in SAMPLES_ALL:
        tc = read_banner(os.path.join(sample_dir, name))
        assert tc.is_matrix and tc.is_sparse


def test_typecode_predicates():
    tc = MMTypeCode.parse("%%MatrixMarket matrix coordinate pattern symmetric")
    assert tc.is_pattern and tc.is_symmetric and tc.is_coordinate
    assert not tc.is_general and not tc.is_real
    assert str(tc) == "matrix coordinate pattern symmetric"

    tc2 = MMTypeCode.parse("%%MatrixMarket matrix array real general")
    assert tc2.is_array and tc2.is_dense and not tc2.is_sparse


def test_banner_case_insensitive():
    tc = MMTypeCode.parse("%%MatrixMarket MATRIX Coordinate Real General")
    assert tc.is_real and tc.is_general


def test_bad_banner_raises():
    with pytest.raises(MTXNoHeader):
        MMTypeCode.parse("% not a banner")
    with pytest.raises(MTXPrematureEOF):
        MMTypeCode.parse("%%MatrixMarket matrix coordinate")
    with pytest.raises(MTXUnsupportedType):
        MMTypeCode.parse("%%MatrixMarket matrix coordinate quaternion general")


# ---------------------------------------------------------------------------
# Error paths (badfile.mtx = 0-byte fixture)
# ---------------------------------------------------------------------------


def test_empty_file_premature_eof(sample_dir):
    with pytest.raises(MTXPrematureEOF):
        read_mtx_raw(os.path.join(sample_dir, "badfile.mtx"))


def test_truncated_data_premature_eof():
    src = io.StringIO("%%MatrixMarket matrix coordinate real general\n3 3 5\n1 1 2.0\n")
    with pytest.raises(MTXPrematureEOF):
        read_mtx_raw(src)


def test_missing_size_line():
    src = io.StringIO("%%MatrixMarket matrix coordinate real general\n% only comments\n")
    with pytest.raises(MTXPrematureEOF):
        read_mtx_raw(src)


def test_out_of_bounds_index():
    src = io.StringIO("%%MatrixMarket matrix coordinate real general\n2 2 1\n3 1 1.0\n")
    with pytest.raises(MTXError):
        read_mtx_raw(src)


# ---------------------------------------------------------------------------
# Loader semantics
# ---------------------------------------------------------------------------


def test_pattern_values_are_one(sample_dir):
    tc, m, n, r, c, v = read_mtx_raw(os.path.join(sample_dir, "ibm32.mtx"))
    assert tc.is_pattern
    assert (m, n) == (32, 32)
    assert len(r) == 126
    assert (v == 1.0).all()
    assert r.min() >= 0 and r.max() < 32  # 0-based


def test_real_values(sample_dir):
    tc, m, n, r, c, v = read_mtx_raw(os.path.join(sample_dir, "pdp08-pg4.mtx"))
    assert tc.is_real
    assert (m, n, len(r)) == (6, 6, 16)
    r0, c0, v0, _ = sample_triplets("pdp08-pg4")
    np.testing.assert_array_equal(r, r0)
    np.testing.assert_array_equal(c, c0)
    np.testing.assert_array_equal(v, v0)  # %.17g round-trips f64


def test_symmetric_not_expanded_by_default(sample_dir):
    coo = read_mtx(os.path.join(sample_dir, "pwt.mtx"), use_native=False)
    # Literal reference behavior: stored entries only (SURVEY.md §B7).
    assert coo.nnz == 181313


def test_symmetric_expansion():
    src = io.StringIO(
        "%%MatrixMarket matrix coordinate real symmetric\n"
        "3 3 4\n1 1 1.0\n2 1 5.0\n3 2 6.0\n3 3 2.0\n"
    )
    coo = read_mtx(src, expand_symmetry=True)
    dense = coo.to_dense()
    assert coo.nnz == 6  # 4 stored + 2 mirrored off-diagonals
    np.testing.assert_allclose(dense, dense.T)
    assert dense[1, 0] == 5.0 and dense[0, 1] == 5.0  # mirrored
    assert dense[0, 0] == 1.0  # diagonal not duplicated


def test_skew_symmetric_expansion():
    src = io.StringIO(
        "%%MatrixMarket matrix coordinate real skew-symmetric\n"
        "3 3 2\n2 1 4.0\n3 2 -1.0\n"
    )
    coo = read_mtx(src, expand_symmetry=True)
    dense = coo.to_dense()
    np.testing.assert_allclose(dense, -dense.T)


def test_integer_field():
    src = io.StringIO(
        "%%MatrixMarket matrix coordinate integer general\n2 2 2\n1 1 7\n2 2 -3\n"
    )
    tc, m, n, r, c, v = read_mtx_raw(src)
    assert tc.is_integer
    assert v[0] == 7.0 and v[1] == -3.0


def test_complex_field():
    src = io.StringIO(
        "%%MatrixMarket matrix coordinate complex general\n"
        "2 2 2\n1 1 1.0 2.0\n2 2 3.0 -4.0\n"
    )
    tc, m, n, r, c, v = read_mtx_raw(src)
    assert tc.is_complex
    assert v[0] == 1 + 2j and v[1] == 3 - 4j


def test_array_format_column_major():
    src = io.StringIO(
        "%%MatrixMarket matrix array real general\n2 2\n1\n2\n3\n4\n"
    )
    tc, m, n, r, c, v = read_mtx_raw(src)
    assert tc.is_array
    dense = np.zeros((2, 2))
    dense[r, c] = v
    np.testing.assert_allclose(dense, [[1, 3], [2, 4]])


# ---------------------------------------------------------------------------
# Writer round trips (mmio-writetest.c / mmio-readtest.c analog)
# ---------------------------------------------------------------------------


def test_write_read_roundtrip_real():
    rng = np.random.RandomState(42)
    r = np.array([0, 1, 4, 4], dtype=np.int32)
    c = np.array([3, 0, 2, 4], dtype=np.int32)
    v = rng.randn(4)
    buf = io.StringIO()
    write_mtx(buf, r, c, v, shape=(5, 5))
    buf.seek(0)
    tc, m, n, r2, c2, v2 = read_mtx_raw(buf)
    assert tc.is_real and (m, n) == (5, 5)
    np.testing.assert_array_equal(r, r2)
    np.testing.assert_array_equal(c, c2)
    np.testing.assert_array_equal(v, v2)  # %.17g is f64-lossless


def test_write_read_roundtrip_pattern():
    r = np.array([0, 2], dtype=np.int32)
    c = np.array([1, 0], dtype=np.int32)
    buf = io.StringIO()
    write_mtx(buf, r, c, None, shape=(3, 3))
    buf.seek(0)
    tc, m, n, r2, c2, v2 = read_mtx_raw(buf)
    assert tc.is_pattern
    np.testing.assert_array_equal(r, r2)
    np.testing.assert_array_equal(c, c2)
    assert (v2 == 1.0).all()


def test_write_fixed_matrix_like_writetest(tmp_path):
    # mmio-writetest.c emits a fixed 4-nnz 10x10 matrix; same here.
    path = tmp_path / "out.mtx"
    r = np.array([0, 3, 6, 9])
    c = np.array([0, 3, 6, 9])
    v = np.array([1.0, 2.5, 3.5, 4.0])
    write_mtx(str(path), r, c, v, shape=(10, 10), comment=" test matrix")
    tc, m, n, r2, c2, v2 = read_mtx_raw(str(path))
    assert (m, n) == (10, 10)
    np.testing.assert_array_equal(v, v2)
    text = path.read_text()
    assert text.startswith("%%MatrixMarket matrix coordinate real general\n")
    assert "% test matrix" in text


def test_all_samples_load(sample_dir):
    expected = {
        "ibm32.mtx": (32, 32, 126),
        "curtis54.mtx": (54, 54, 291),
        "pdp08-pg4.mtx": (6, 6, 16),
        "memplus.mtx": (17758, 17758, 126150),
        "pwt.mtx": (36519, 36519, 181313),
    }
    for name, (m, n, nnz) in expected.items():
        coo = read_mtx(os.path.join(sample_dir, name), use_native=False)
        assert coo.shape == (m, n), name
        assert coo.nnz == nnz, name


def test_write_array_format_roundtrip():
    from smvp_toolkit_tpu.io.mtx import write_mtx_array

    rng = np.random.RandomState(9)
    dense = rng.randn(3, 4)
    buf = io.StringIO()
    write_mtx_array(buf, dense)
    buf.seek(0)
    tc, m, n, r, c, v = read_mtx_raw(buf)
    assert tc.is_array and (m, n) == (3, 4)
    back = np.zeros((3, 4))
    back[r, c] = v
    np.testing.assert_array_equal(back, dense)  # %.17g is lossless


def test_profile_trace_smoke(tmp_path):
    import jax.numpy as jnp

    from smvp_toolkit_tpu.bench.profile import profile_fn

    out = profile_fn(
        lambda x: x * 2, jnp.ones(16), log_dir=str(tmp_path), iterations=2
    )
    assert float(out.sum()) == 32.0
    assert any(tmp_path.rglob("*"))  # trace files written


@pytest.mark.parametrize("seed", range(10))
def test_parser_fuzz_never_crashes(seed):
    """Malformed input must raise MTXError subclasses, never anything else."""
    rng = np.random.RandomState(seed)
    fragments = [
        "%%MatrixMarket matrix coordinate real general\n",
        "%%MatrixMarket matrix coordinate pattern symmetric\n",
        "%%MatrixMarket bogus\n",
        "% comment\n",
        "3 3 4\n",
        "3 3\n",
        "1 1 2.5\n",
        "-1 7 0.1\n",
        "abc def\n",
        "1e999 2 3\n",
        "",
        "\x00\x01\x02\n",
    ]
    n = rng.randint(1, 6)
    text = "".join(fragments[i] for i in rng.randint(0, len(fragments), n))
    try:
        read_mtx_raw(io.StringIO(text))
    except MTXError:
        pass  # expected failure mode
    except ValueError:
        pass  # numeric conversion failure surfaced as ValueError is fine


def test_complex_matrix_needs_complex_dtype():
    import jax.numpy as jnp

    src = (
        "%%MatrixMarket matrix coordinate complex general\n"
        "2 2 2\n1 1 1.0 2.0\n2 2 3.0 -4.0\n"
    )
    # Default dtype auto-promotes to complex64 (never drops imag parts).
    coo = read_mtx(io.StringIO(src))
    v = np.asarray(coo.vals)[: coo.nnz]
    assert v[0] == np.complex64(1 + 2j)
    # An explicit real dtype is refused rather than silently truncated.
    with pytest.raises(MTXUnsupportedType):
        read_mtx(io.StringIO(src), dtype=jnp.float32)


def test_array_symmetric_lower_triangle():
    src = io.StringIO(
        "%%MatrixMarket matrix array real symmetric\n2 2\n1.0\n2.0\n3.0\n"
    )
    tc, m, n, r, c, v = read_mtx_raw(src)
    dense = np.zeros((2, 2))
    dense[r, c] = v
    np.testing.assert_array_equal(dense, [[1.0, 0.0], [2.0, 3.0]])


def test_array_skew_lower_triangle():
    src = io.StringIO(
        "%%MatrixMarket matrix array real skew-symmetric\n3 3\n1.0\n2.0\n3.0\n"
    )
    tc, m, n, r, c, v = read_mtx_raw(src)
    assert len(r) == 3  # strictly-lower entries only
    assert (r > c).all()


def test_malformed_value_raises_typed_error():
    src = io.StringIO(
        "%%MatrixMarket matrix coordinate real general\n2 2 1\n1 1 abc\n"
    )
    with pytest.raises(MTXError):
        read_mtx_raw(src)


def test_negative_size_raises_typed_error():
    src = io.StringIO(
        "%%MatrixMarket matrix coordinate real general\n-2 2 1\n1 1 1.0\n"
    )
    with pytest.raises(MTXError):
        read_mtx_raw(src)


def test_symmetric_must_be_square(tmp_path):
    """A rectangular symmetric declaration raises a typed MTXError, not a
    raw numpy ValueError (round-1 advisor finding)."""
    import pytest

    from smvp_toolkit_tpu.io.mtx import MTXError, read_mtx

    p = tmp_path / "rect_sym_array.mtx"
    p.write_text(
        "%%MatrixMarket matrix array real symmetric\n3 5\n"
        + "1.0\n" * 6
    )
    with pytest.raises(MTXError):
        read_mtx(str(p))
    p2 = tmp_path / "rect_sym_coord.mtx"
    p2.write_text(
        "%%MatrixMarket matrix coordinate real symmetric\n3 5 2\n"
        "1 1 1.0\n2 2 2.0\n"
    )
    with pytest.raises(MTXError):
        read_mtx(str(p2))


def test_gzipped_mtx_loads(tmp_path, sample_dir):
    """SuiteSparse-style .mtx.gz files stream-decompress transparently."""
    import gzip
    import shutil

    src = os.path.join(sample_dir, "curtis54.mtx")
    gz = tmp_path / "curtis54.mtx.gz"
    with open(src, "rb") as fin, gzip.open(gz, "wb") as fout:
        shutil.copyfileobj(fin, fout)
    plain = read_mtx(src)
    packed = read_mtx(str(gz))
    assert packed.nnz == plain.nnz
    np.testing.assert_array_equal(packed.to_dense(), plain.to_dense())


def test_write_mtx_gz_round_trip(tmp_path):
    rng = np.random.RandomState(50)
    r = rng.randint(0, 9, 30).astype(np.int64)
    c = rng.randint(0, 7, 30).astype(np.int64)
    v = rng.randn(30)
    path = str(tmp_path / "rt.mtx.gz")
    write_mtx(path, r, c, v, (9, 7))
    import gzip

    with open(path, "rb") as f:
        assert f.read(2) == b"\x1f\x8b"  # actually gzip-compressed
    back = read_mtx(path)
    dense = np.zeros((9, 7))
    np.add.at(dense, (r, c), v)
    np.testing.assert_allclose(back.to_dense(), dense, rtol=1e-6,
                               atol=1e-9)


def test_expand_symmetry_retypes_general(tmp_path):
    """read_mtx(expand_symmetry=True) must retype the result general:
    the triplets hold the full matrix, so a surviving symmetric
    typecode would make every typecode-aware consumer (to_dense,
    to_scipy, algebra expansion) mirror the off-diagonals twice."""
    import numpy as np

    from smvp_toolkit_tpu.io.mtx import read_mtx, write_mtx

    a = np.array([[4.0, -1.0, 0.0],
                  [-1.0, 4.0, -2.0],
                  [0.0, -2.0, 4.0]])
    r, c = np.nonzero(np.tril(a))
    path = tmp_path / "sym.mtx"
    write_mtx(str(path), r.astype(np.int32), c.astype(np.int32),
              a[r, c], a.shape, field="real", symmetry="symmetric")
    coo = read_mtx(str(path), expand_symmetry=True)
    assert coo.typecode.is_general
    np.testing.assert_array_equal(coo.to_dense(), a)
    # and the unexpanded read still carries the storage typecode with
    # only the stored triangle materialized (reference semantics —
    # to_dense is the stored-entries oracle; to_scipy expands)
    coo_stored = read_mtx(str(path))
    assert coo_stored.typecode.symmetry == "symmetric"
    np.testing.assert_array_equal(coo_stored.to_dense(), np.tril(a))
    np.testing.assert_array_equal(coo_stored.to_scipy().toarray(), a)
