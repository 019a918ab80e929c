"""Auxiliary subsystem tests: checkpoint/resume, synth generators, debug
dumps, Vivado LUT emitter, readtest/writetest entry points."""

import io
import os
import subprocess
import sys

import numpy as np
import pytest

from smvp_toolkit_tpu.formats.coo import COOMatrix
from smvp_toolkit_tpu.formats.csr import csr_encode, csr_decode
from smvp_toolkit_tpu.formats.tjds import tjds_encode
from smvp_toolkit_tpu.formats.vivado import write_tjds_lut
from smvp_toolkit_tpu.io.mtx import read_mtx
from smvp_toolkit_tpu.utils.checkpoint import load_matrix, save_matrix
from smvp_toolkit_tpu.utils.debug import dump_coo, dump_csr, dump_tjds
from smvp_toolkit_tpu.utils.synth import synth_banded, synth_powerlaw, synth_uniform

from conftest import SAMPLE_DIR


def _load(name):
    return read_mtx(os.path.join(SAMPLE_DIR, name), use_native=False)


# ---------------------------------------------------------------------------
# Checkpoint / resume
# ---------------------------------------------------------------------------


def test_checkpoint_coo_roundtrip(tmp_path):
    coo = _load("pdp08-pg4.mtx")
    path = tmp_path / "coo.npz"
    save_matrix(str(path), coo)
    loaded = load_matrix(str(path))
    assert isinstance(loaded, COOMatrix)
    assert loaded.shape == coo.shape and loaded.nnz == coo.nnz
    assert str(loaded.typecode) == str(coo.typecode)
    for a, b in zip(loaded.to_numpy(), coo.to_numpy()):
        np.testing.assert_array_equal(a, b)


def test_checkpoint_csr_roundtrip(tmp_path):
    coo = _load("curtis54.mtx").pad(64)
    csr = csr_encode(coo)
    path = tmp_path / "csr.npz"
    save_matrix(str(path), csr)
    loaded = load_matrix(str(path))
    np.testing.assert_array_equal(np.asarray(loaded.row_ptr), np.asarray(csr.row_ptr))
    np.testing.assert_array_equal(np.asarray(loaded.vals), np.asarray(csr.vals))
    # Decode from the loaded checkpoint still bit-exact.
    dec = csr_decode(loaded)
    canon = coo.canonical_order()
    np.testing.assert_array_equal(dec.to_numpy()[2], canon.to_numpy()[2])


def test_checkpoint_tjds_roundtrip(tmp_path):
    from smvp_toolkit_tpu.ops import spmv_tjds
    import jax.numpy as jnp

    coo = _load("curtis54.mtx").pad(64)
    tj = tjds_encode(coo)
    path = tmp_path / "tjds.npz"
    save_matrix(str(path), tj)
    loaded = load_matrix(str(path))
    x = jnp.ones((coo.shape[1],), jnp.float32)
    np.testing.assert_array_equal(
        np.asarray(spmv_tjds(loaded, x)), np.asarray(spmv_tjds(tj, x))
    )


def test_checkpoint_rejects_unknown():
    with pytest.raises(TypeError):
        save_matrix("/tmp/x.npz", object())


# ---------------------------------------------------------------------------
# Synthetic generators
# ---------------------------------------------------------------------------


def test_synth_banded():
    coo = synth_banded(500, nnz_per_row=5, bandwidth=16, seed=1)
    r, c, v = coo.to_numpy()
    assert (np.abs(r.astype(int) - c.astype(int)) <= 16).all()
    assert coo.shape == (500, 500)
    # No duplicate coordinates.
    keys = r.astype(np.int64) * 500 + c
    assert len(np.unique(keys)) == len(keys)


def test_synth_uniform_and_powerlaw():
    u = synth_uniform(100, 80, 400, seed=2)
    assert u.shape == (100, 80)
    p = synth_powerlaw(200, 1000, seed=3)
    r, c, v = p.to_numpy()
    # Power-law: low-index columns should be much more popular.
    low = (c < 20).sum()
    high = (c >= 180).sum()
    assert low > high


def test_synth_spmv_correct():
    from smvp_toolkit_tpu.formats.csr import csr_encode
    from smvp_toolkit_tpu.ops import spmv_csr
    import jax.numpy as jnp

    coo = synth_banded(300, seed=4).pad(128)
    csr = csr_encode(coo)
    rng = np.random.RandomState(0)
    x = jnp.asarray(rng.randn(300), jnp.float32)
    y = np.asarray(spmv_csr(csr, x))
    y_ref = coo.to_dense() @ np.asarray(x, np.float64)
    np.testing.assert_allclose(y, y_ref, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# Debug dumps
# ---------------------------------------------------------------------------


def test_debug_dumps():
    coo = _load("pdp08-pg4.mtx").pad(32)
    csr = csr_encode(coo)
    tj = tjds_encode(coo)
    buf = io.StringIO()
    dump_coo(coo, file=buf)
    dump_csr(csr, file=buf)
    dump_tjds(tj, file=buf)
    text = buf.getvalue()
    assert "COO (6, 6) nnz=16" in text
    assert "row_ptr" in text
    assert "start_pos" in text
    assert "diag 0" in text


# ---------------------------------------------------------------------------
# Vivado LUT emitter
# ---------------------------------------------------------------------------


def test_tjds_lut_grid_matches_matrix():
    # The reference hardcoded a 10x36520 grid (main-cli.c:1031-1064) and
    # crashed on pdp08-pg4; ours derives the grid from the matrix.
    coo = _load("pdp08-pg4.mtx").pad(32)
    tj = tjds_encode(coo)
    text = write_tjds_lut(tj)
    lines = [ln for ln in text.splitlines() if ln]
    assert len(lines) == coo.nnz  # one assignment per packed entry
    assert lines[0].startswith("assign tjds_lut[0][0] = ")
    nd = int(tj.num_diags)
    assert f"[{nd - 1}][" in text
    assert f"[{nd}][" not in text


def test_tjds_lut_max_diags(tmp_path):
    coo = _load("curtis54.mtx").pad(64)
    tj = tjds_encode(coo)
    path = tmp_path / "lut.v"
    write_tjds_lut(tj, str(path), max_diags=2)
    text = path.read_text()
    assert "[1][" in text and "[2][" not in text


# ---------------------------------------------------------------------------
# readtest / writetest entry points (reference mmio test programs)
# ---------------------------------------------------------------------------


def test_readtest_roundtrip(capsys):
    from smvp_toolkit_tpu.io.readtest import main as readtest_main

    rc = readtest_main([os.path.join(SAMPLE_DIR, "pdp08-pg4.mtx")])
    assert rc == 0
    out = capsys.readouterr().out
    assert out.startswith("%%MatrixMarket matrix coordinate real general")
    assert "6 6 16" in out


def test_readtest_usage(capsys):
    from smvp_toolkit_tpu.io.readtest import main as readtest_main

    assert readtest_main([]) == 2


def test_writetest_fixed_matrix(capsys):
    from smvp_toolkit_tpu.io.writetest import main as writetest_main

    assert writetest_main([]) == 0
    out = capsys.readouterr().out
    assert "10 10 4" in out
    assert "10 10 4\n1 1 1\n4 4 2.5\n7 7 3.5\n10 10 4\n" in out


def test_analyze():
    from smvp_toolkit_tpu.utils.analyze import analyze, format_analysis

    coo = _load("curtis54.mtx")
    stats = analyze(coo)
    assert stats["nnz"] == 291
    assert stats["row_len"]["max"] >= stats["row_len"]["p50"]
    r, c, _ = coo.to_numpy()
    assert stats["row_len"]["max"] == np.bincount(r).max()
    assert stats["tjds_diags"] == np.bincount(c).max()
    text = format_analysis(stats)
    assert "TJDS diagonals" in text and "bandwidth" in text


def test_analyze_empty():
    from smvp_toolkit_tpu.utils.analyze import analyze

    coo = COOMatrix.from_numpy(
        np.zeros(0, np.int32), np.zeros(0, np.int32), np.zeros(0),
        shape=(5, 5),
    )
    stats = analyze(coo)
    assert stats["nnz"] == 0


def test_native_spmv_matches_oracle():
    from smvp_toolkit_tpu.ops.spmv_native import (
        NativeCsrSpMV,
        native_spmv_available,
    )

    if not native_spmv_available():
        pytest.skip("libspmv.so not built")
    coo = _load("curtis54.mtx").pad(64)
    csr = csr_encode(coo)
    rng = np.random.RandomState(3)
    x = rng.randn(coo.shape[1]).astype(np.float32)
    for threads in (1, 4):
        y = NativeCsrSpMV(csr, threads=threads)(x)
        y_ref = coo.to_dense() @ x.astype(np.float64)
        np.testing.assert_allclose(y, y_ref, rtol=1e-4, atol=1e-4)


def test_native_tjds_matches_oracle():
    from smvp_toolkit_tpu.ops.spmv_native import (
        NativeTjdsSpMV,
        native_spmv_available,
    )

    if not native_spmv_available():
        pytest.skip("libspmv.so not built")
    coo = _load("curtis54.mtx").pad(64)
    tj = tjds_encode(coo)
    rng = np.random.RandomState(5)
    x = rng.randn(coo.shape[1]).astype(np.float32)
    y = NativeTjdsSpMV(tj)(x)
    y_ref = coo.to_dense() @ x.astype(np.float64)
    np.testing.assert_allclose(y, y_ref, rtol=1e-4, atol=1e-4)


def test_native_tjds_empty_matrix_threaded():
    from smvp_toolkit_tpu.ops.spmv_native import (
        NativeTjdsSpMV,
        native_spmv_available,
    )

    if not native_spmv_available():
        pytest.skip("libspmv.so not built")
    coo = COOMatrix.from_numpy(
        np.zeros(0, np.int32), np.zeros(0, np.int32), np.zeros(0),
        shape=(8, 8),
    )
    tj = tjds_encode(coo.pad(8))
    y = NativeTjdsSpMV(tj, threads=4)(np.ones(8, np.float32))
    np.testing.assert_array_equal(y, np.zeros(8))


def test_analyze_complex_matrix():
    """--analyze must not crash on complex matrices."""
    import io as _io

    from smvp_toolkit_tpu.io.mtx import read_mtx
    from smvp_toolkit_tpu.utils.analyze import analyze, format_analysis

    s = ("%%MatrixMarket matrix coordinate complex general\n2 2 2\n"
         "1 1 1.0 2.0\n2 2 3.0 -1.0\n")
    coo = read_mtx(_io.StringIO(s)).pad(8)
    text = format_analysis(analyze(coo))
    assert "TJDS diagonals" in text
    assert "shape 2x2  nnz 2" in text


@pytest.mark.parametrize("fmt", ["coo", "csr", "tjds"])
def test_matrix_checkpoint_roundtrip_drives_spmv(tmp_path, fmt):
    """Encoded matrices save/load bit-exactly and the reloaded matrix
    gives the same y."""
    import jax.numpy as jnp

    from smvp_toolkit_tpu.formats.csr import csr_encode
    from smvp_toolkit_tpu.formats.tjds import tjds_encode
    from smvp_toolkit_tpu.ops import spmv_coo, spmv_csr, spmv_tjds
    from smvp_toolkit_tpu.utils.checkpoint import load_matrix, save_matrix

    coo = _load("curtis54.mtx").pad(64)
    enc, spmv = {
        "coo": (coo, spmv_coo),
        "csr": (csr_encode(coo), spmv_csr),
        "tjds": (tjds_encode(coo), spmv_tjds),
    }[fmt]
    p = tmp_path / f"{fmt}.npz"
    save_matrix(p, enc)
    back = load_matrix(p)
    x = jnp.asarray(np.random.RandomState(0).randn(coo.shape[1]).astype(np.float32))
    np.testing.assert_array_equal(
        np.asarray(spmv(enc, x)), np.asarray(spmv(back, x))
    )
