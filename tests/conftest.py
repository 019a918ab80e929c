"""Test harness configuration.

Tests run on CPU with 8 virtual devices
(``--xla_force_host_platform_device_count=8``) so multi-device sharding
is exercised without a GPU; the platform is pinned in-process before the
first backend use (``jax.config.update`` works even though a pytest
plugin may already have imported jax, because backends initialize
lazily). Tests that need the card carry the ``gpu`` marker and skip
there (see the ``gpu`` fixture); ``chip_smoke.py`` runs the card's path,
and ``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`` runs them on
the card.

The reference toolkit's sample matrices are not distributed with this
repository: the session writes generated stand-ins of the same names,
shapes, nonzero counts and type codes into ``SAMPLE_DIR``
(``smvp_toolkit_tpu.utils.synth.sample_triplets``), plus the 0-byte
``badfile.mtx`` error fixture. Assertions compare against scipy.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import pytest

import jax  # noqa: E402

# The CPU unless another platform is asked for by name
# (``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`` on the card).
if os.environ.get("JAX_PLATFORMS", "cpu") == "cpu":
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    jax.config.update("jax_platforms", "cpu")

SAMPLE_DIR = os.path.join(tempfile.gettempdir(), "smvp-sample-data")


def _write_samples() -> None:
    """Write the stand-in sample matrices (atomic per file, so workers
    that write the same bytes concurrently never expose a partial file;
    rewritten every session, so files from an older generator never
    linger)."""
    from smvp_toolkit_tpu.utils.synth import SAMPLE_MATRICES, write_sample_mtx

    os.makedirs(SAMPLE_DIR, exist_ok=True)
    for name in SAMPLE_MATRICES:
        write_sample_mtx(name, os.path.join(SAMPLE_DIR, f"{name}.mtx"))
    open(os.path.join(SAMPLE_DIR, "badfile.mtx"), "w").close()


def pytest_sessionstart(session):
    """Build the native fast-path libraries before collecting tests.

    A fresh checkout has no ``native/*.so``; round 4 shipped with 30+
    native tests silently skipping because nothing ran ``make``. Build
    here (a few seconds, once) and FAIL LOUDLY if anything is still
    missing — skip-on-missing now only covers deliberately disabled
    builds (``SMVP_NO_NATIVE_BUILD=1``).
    """
    from smvp_toolkit_tpu.native import ensure_native

    _write_samples()
    missing, out = ensure_native()
    if missing and os.environ.get("SMVP_NO_NATIVE_BUILD") != "1":
        raise pytest.UsageError(
            "native libraries missing after build attempt: "
            f"{', '.join(missing)}\n{out[-2000:]}"
        )

SAMPLES_SMALL = ["ibm32.mtx", "curtis54.mtx", "pdp08-pg4.mtx"]
SAMPLES_LARGE = ["memplus.mtx", "pwt.mtx"]
SAMPLES_ALL = SAMPLES_SMALL + SAMPLES_LARGE


@pytest.fixture(scope="session")
def sample_dir() -> str:
    return SAMPLE_DIR


@pytest.fixture
def gpu():
    """The first JAX device if it is a GPU; skips the test otherwise.

    Decided here, at run time, never at import or collection time, so
    every pytest-xdist worker collects the same tests.
    """
    device = jax.devices()[0]
    if device.platform != "gpu":
        pytest.skip("needs the GPU; chip_smoke.py runs this path on the card")
    return device


def random_coo(
    rng: np.random.RandomState,
    nrows: int,
    ncols: int,
    nnz: int,
    *,
    allow_duplicates: bool = False,
    empty_rows: bool = True,
):
    """Random sparsity pattern for property tests (incl. empty rows/cols)."""
    if allow_duplicates:
        r = rng.randint(0, nrows, size=nnz)
        c = rng.randint(0, ncols, size=nnz)
    else:
        flat = rng.choice(nrows * ncols, size=min(nnz, nrows * ncols), replace=False)
        r, c = np.divmod(flat, ncols)
    if not empty_rows and nrows <= len(r):
        # Force each row to appear at least once.
        r[: nrows] = np.arange(nrows)
    v = rng.randn(len(r))
    return r.astype(np.int32), c.astype(np.int32), v


def poisson2d(nx: int) -> "np.ndarray":
    """Dense 5-point 2-D Dirichlet Laplacian (SPD, cond ~ nx²) — the
    shared SPD fixture for preconditioner/eigensolver tests."""
    import scipy.sparse as sp

    eye = sp.eye(nx)
    t = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], (nx, nx))
    return np.asarray((sp.kron(eye, t) + sp.kron(t, eye)).todense())
