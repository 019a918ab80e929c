"""Native (C++) fast paths: build helpers.

The shared libraries in this directory are OPTIONAL accelerators — every
caller falls back to a numpy/XLA path — but silently missing libraries
turn a fresh checkout into a slower framework with 30+ silently skipped
tests. :func:`ensure_native` builds them on demand
(one ``make`` invocation) and reports what is still missing so callers
can fail loudly instead.
"""

from __future__ import annotations

import os
import subprocess
from typing import List, Tuple

NATIVE_DIR = os.path.dirname(os.path.abspath(__file__))

LIBS = [
    "libmtxio.so",
    "libcisr.so",
    "libspmv.so",
    "libencode.so",
    "libilu.so",
    "libamg.so",
]


def missing_libs() -> List[str]:
    return [
        lib
        for lib in LIBS
        if not os.path.exists(os.path.join(NATIVE_DIR, lib))
    ]


def ensure_native(verbose: bool = False) -> Tuple[List[str], str]:
    """Build any missing native libraries via ``make``.

    Returns ``(still_missing, make_output)``. Never raises: callers
    decide whether a missing library is an error (the test session) or
    a fallback (runtime imports). Set ``SMVP_NO_NATIVE_BUILD=1`` to skip
    the build attempt (e.g. sandboxed environments without a compiler).
    """
    miss = missing_libs()
    if not miss or os.environ.get("SMVP_NO_NATIVE_BUILD") == "1":
        return miss, ""
    try:
        proc = subprocess.run(
            ["make", "-C", NATIVE_DIR, "-j"],
            capture_output=True,
            text=True,
            timeout=600,
        )
        out = proc.stdout + proc.stderr
    except (OSError, subprocess.TimeoutExpired) as e:  # no make, etc.
        out = f"native build failed to run: {e}"
    if verbose and out:
        print(out)
    return missing_libs(), out
