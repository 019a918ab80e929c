"""CISR scheduler + .coe emitter tests.

Validates the slot-group schedule semantics (reference main-cli.c:542-612),
the round-trip decode, and the packed-word spec (main-cli.c:673-688).
"""

import os

import numpy as np
import pytest

from smvp_toolkit_tpu.formats.cisr import (
    cisr_encode,
    cisr_decode,
    pack_rowlen_word,
    pack_value_word,
    write_coe,
)
from smvp_toolkit_tpu.formats.coo import COOMatrix
from smvp_toolkit_tpu.io.mtx import read_mtx

from conftest import SAMPLE_DIR, SAMPLES_ALL, SAMPLES_SMALL, random_coo


def _load(name):
    return read_mtx(os.path.join(SAMPLE_DIR, name), use_native=False)


def test_simple_schedule():
    # 2 slots, rows of lengths [2, 1, 1]: slot0 gets row0, slot1 gets row1
    # then row2.
    r = np.array([0, 0, 1, 2], dtype=np.int32)
    c = np.array([0, 1, 0, 1], dtype=np.int32)
    v = np.array([1.0, 2.0, 3.0, 4.0])
    coo = COOMatrix.from_numpy(r, c, v, shape=(3, 2))
    cisr = cisr_encode(coo, slot_count=2)
    assert cisr.num_groups == 2
    np.testing.assert_allclose(cisr.vals, [[1.0, 3.0], [2.0, 4.0]])
    np.testing.assert_array_equal(cisr.row_of, [[0, 1], [0, 2]])
    np.testing.assert_array_equal(cisr.row_lengths, [2, 1, 1])


def test_idle_slot_zero_padding():
    # One long row, 2 slots: slot1 idles with zero padding.
    r = np.array([0, 0, 0], dtype=np.int32)
    c = np.array([0, 1, 2], dtype=np.int32)
    v = np.array([5.0, 6.0, 7.0])
    coo = COOMatrix.from_numpy(r, c, v, shape=(1, 3))
    cisr = cisr_encode(coo, slot_count=2)
    assert cisr.num_groups == 3
    np.testing.assert_allclose(cisr.vals[:, 1], [0.0, 0.0, 0.0])
    np.testing.assert_array_equal(cisr.row_of[:, 1], [-1, -1, -1])


def test_empty_rows_consume_no_beats():
    # Reference mis-handles empty rows (it has none in samples); we must
    # record length 0 and not emit phantom entries.
    r = np.array([0, 3], dtype=np.int32)
    c = np.array([0, 1], dtype=np.int32)
    v = np.array([1.0, 2.0])
    coo = COOMatrix.from_numpy(r, c, v, shape=(4, 2))
    cisr = cisr_encode(coo, slot_count=2)
    np.testing.assert_array_equal(cisr.row_lengths, [1, 0, 0, 1])
    dec = cisr_decode(cisr)
    np.testing.assert_allclose(dec.to_dense(), coo.to_dense())


@pytest.mark.parametrize("name", SAMPLES_SMALL)
@pytest.mark.parametrize("slots", [1, 4, 16])
def test_roundtrip_samples(name, slots):
    coo = _load(name)
    cisr = cisr_encode(coo, slot_count=slots)
    assert cisr.row_lengths.sum() == coo.nnz
    dec = cisr_decode(cisr)
    assert dec.nnz == coo.nnz
    np.testing.assert_allclose(dec.to_dense(), coo.to_dense())


@pytest.mark.parametrize("seed", range(3))
def test_roundtrip_random(seed):
    rng = np.random.RandomState(seed)
    nrows, ncols = rng.randint(1, 40), rng.randint(1, 40)
    nnz = rng.randint(1, max(2, nrows * ncols // 2))
    r, c, v = random_coo(rng, nrows, ncols, nnz)
    coo = COOMatrix.from_numpy(r, c, v, shape=(nrows, ncols))
    cisr = cisr_encode(coo, slot_count=int(rng.randint(1, 8)))
    dec = cisr_decode(cisr)
    np.testing.assert_allclose(dec.to_dense(), coo.to_dense(), rtol=1e-6)


def test_value_word_packing():
    # 12-bit value, 12-bit col, 8-bit slot (main-cli.c:673-688 spec).
    w = pack_value_word(3.7, 5, 2)
    assert w == (3 << 20) | (5 << 8) | 2
    # Masking (reference §B8: C shift overflow; we truncate explicitly).
    assert pack_value_word(0x1FFF, 0x1FFF, 0x1FF) == (0xFFF << 20) | (0xFFF << 8) | 0xFF


def test_rowlen_word_packing():
    assert pack_rowlen_word(3, 7) == (1 << 28) | (3 << 16) | (1 << 12) | 7
    assert pack_rowlen_word(3, None) == (1 << 28) | (3 << 16)


def test_coe_structure():
    coo = _load("pdp08-pg4.mtx")
    cisr = cisr_encode(coo, slot_count=4)
    text = write_coe(cisr)
    lines = [ln for ln in text.splitlines() if ln and not ln.startswith(";")]
    assert lines[0] == "memory_initialization_radix=16;"
    assert lines[1] == "memory_initialization_vector="
    assert lines[2] == "00aaaaaaaa,"
    assert lines[-1] == "03ffffffff;"
    value_words = [ln for ln in lines if ln.startswith("01")]
    rowlen_words = [ln for ln in lines if ln.startswith("02")]
    assert len(value_words) == cisr.num_groups * cisr.slot_count
    assert len(rowlen_words) == -(-coo.shape[0] // 2)  # two lengths per word


def test_coe_write_to_file(tmp_path):
    coo = _load("pdp08-pg4.mtx")
    cisr = cisr_encode(coo, slot_count=4)
    path = tmp_path / "out.coe"
    write_coe(cisr, str(path))
    assert path.read_text().startswith(";")


def test_native_scheduler_matches_python():
    """C++ scheduler (native/cisr.cpp) must be beat-for-beat identical."""
    from smvp_toolkit_tpu.formats.cisr import _native_lib

    if _native_lib() is None:
        pytest.skip("libcisr.so not built")
    for name in SAMPLES_SMALL:
        coo = _load(name)
        for slots in (1, 3, 16):
            a = cisr_encode(coo, slots, use_native=True)
            b = cisr_encode(coo, slots, use_native=False)
            assert a.num_groups == b.num_groups
            np.testing.assert_array_equal(a.vals, b.vals)
            np.testing.assert_array_equal(a.col_ind, b.col_ind)
            np.testing.assert_array_equal(a.row_of, b.row_of)
            np.testing.assert_array_equal(a.row_lengths, b.row_lengths)


def test_native_scheduler_empty_rows():
    from smvp_toolkit_tpu.formats.cisr import _native_lib

    if _native_lib() is None:
        pytest.skip("libcisr.so not built")
    r = np.array([0, 3], dtype=np.int32)
    c = np.array([0, 1], dtype=np.int32)
    v = np.array([1.0, 2.0])
    coo = COOMatrix.from_numpy(r, c, v, shape=(4, 2))
    a = cisr_encode(coo, 2, use_native=True)
    b = cisr_encode(coo, 2, use_native=False)
    np.testing.assert_array_equal(a.row_lengths, b.row_lengths)
    np.testing.assert_array_equal(a.row_of, b.row_of)


def test_coe_emits_all_row_lengths_with_many_empty_rows():
    # 40 rows, 4 nnz: beats x slots can hold only 8 lengths inline; the
    # remainder must still be flushed before the end word.
    r = np.array([0, 1, 2, 3], dtype=np.int32)
    c = np.array([0, 1, 2, 3], dtype=np.int32)
    v = np.ones(4)
    coo = COOMatrix.from_numpy(r, c, v, shape=(40, 40))
    cisr = cisr_encode(coo, slot_count=4)
    text = write_coe(cisr)
    rowlen_words = [ln for ln in text.splitlines() if ln.startswith("02")]
    assert len(rowlen_words) == 20  # all 40 lengths, two per word


# ---------------------------------------------------------------------------
# Schedule-consuming SpMV (the compute the reference never implemented)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", SAMPLES_ALL)
def test_cisr_spmv_matches_oracle(name, sample_dir):
    """spmv_cisr executes the interleaved schedule and must agree with a
    float64 host oracle on every reference sample, general x."""
    import jax.numpy as jnp

    from smvp_toolkit_tpu.io.mtx import read_mtx
    from smvp_toolkit_tpu.ops import spmv_cisr

    coo = read_mtx(os.path.join(sample_dir, name))
    r, c, v = coo.to_numpy()
    cisr = cisr_encode(coo, slot_count=16)
    rng = np.random.default_rng(3)
    xh = rng.standard_normal(coo.shape[1]).astype(np.float32)
    y = np.asarray(spmv_cisr(cisr, jnp.asarray(xh))).astype(np.float64)
    y_ref = np.zeros(coo.shape[0])
    np.add.at(y_ref, r, v.astype(np.float64) * xh[c].astype(np.float64))
    scale = np.abs(y_ref).max() + 1e-30
    assert np.abs(y - y_ref).max() / scale < 1e-5


@pytest.mark.parametrize("slots", [1, 3, 16, 128])
def test_cisr_spmv_slot_counts(slots):
    """Correct across channel counts incl. degenerate 1 and lane-wide 128,
    with empty rows in the matrix."""
    import jax.numpy as jnp

    from smvp_toolkit_tpu.formats.coo import COOMatrix
    from smvp_toolkit_tpu.ops import spmv_cisr

    rng = np.random.default_rng(slots)
    nrows, ncols, nnz = 97, 61, 400
    r = rng.integers(0, nrows, nnz).astype(np.int32)
    r[r % 7 == 0] = 5  # force several empty rows + a heavy row
    c = rng.integers(0, ncols, nnz).astype(np.int32)
    # de-duplicate (the CISR scheduler consumes CSR, duplicates coalesce
    # in the oracle but not the schedule stream)
    keys = np.unique(r.astype(np.int64) * ncols + c)
    r = (keys // ncols).astype(np.int32)
    c = (keys % ncols).astype(np.int32)
    v = rng.standard_normal(len(r))
    coo = COOMatrix.from_numpy(r, c, v, shape=(nrows, ncols))
    cisr = cisr_encode(coo, slot_count=slots)
    xh = rng.standard_normal(ncols).astype(np.float32)
    y = np.asarray(spmv_cisr(cisr, jnp.asarray(xh))).astype(np.float64)
    y_ref = np.zeros(nrows)
    np.add.at(y_ref, r, v * xh[c].astype(np.float64))
    scale = np.abs(y_ref).max() + 1e-30
    assert np.abs(y - y_ref).max() / scale < 1e-5


def test_cli_cisr_benchmark_report(tmp_path):
    """-g now also benchmarks the schedule-consuming kernel and writes a
    CISR report whose y matches the CSR math."""
    from smvp_toolkit_tpu.cli import main as cli_main

    rc = cli_main(["-g", "-n", "2", "-d", str(tmp_path),
                   "--coe-out", str(tmp_path / "x.coe"),
                   os.path.join(SAMPLE_DIR, "curtis54.mtx")])
    assert rc == 0
    f = list(tmp_path.glob("smvp-toolbox_report_CISR_*.txt"))[0]
    import re as _re

    body = _re.search(r"\[\n(.*?)\n\]", f.read_text(), _re.S).group(1)
    assert sum(float(t) for t in body.split()) == 291.0


@pytest.mark.parametrize("slots", [1, 7, 16])
def test_cisr_schedule_spmv_matches_scipy(slots):
    """The schedule-faithful CISR SpMV equals scipy at any slot count."""
    import jax.numpy as jnp
    import scipy.sparse as sp

    from smvp_toolkit_tpu.ops import spmv_cisr

    coo = _load("curtis54.mtx")
    cisr = cisr_encode(coo, slot_count=slots)
    rng = np.random.default_rng(9)
    x = rng.standard_normal(coo.shape[1]).astype(np.float32)
    r, c, v = coo.to_numpy()
    ref = sp.csr_matrix((v.astype(np.float64), (r, c)), shape=coo.shape) @ x
    y = np.asarray(spmv_cisr(cisr, jnp.asarray(x)))
    np.testing.assert_allclose(y, ref, rtol=1e-5, atol=1e-5)
