"""Matrix structure analysis: the numbers that drive SpMV kernel choices.

Reports the structural statistics a GPU SpMV's work split depends on
(row-length distribution and skew, empty rows and columns, bandwidth,
density, TJDS diagonal count). Used by the CLI ``--analyze`` flag and by
tests.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from smvp_toolkit_tpu.formats.coo import COOMatrix

__all__ = ["analyze", "format_analysis"]


def analyze(coo: COOMatrix) -> Dict:
    """Compute structure statistics for a COO matrix (host-side)."""
    r, c, v = coo.to_numpy()
    nrows, ncols = coo.shape
    nnz = coo.nnz
    out: Dict = {
        "shape": coo.shape,
        "nnz": int(nnz),
        "density": float(nnz / max(nrows * ncols, 1)),
    }
    if nnz == 0:
        return out

    rl = np.bincount(r, minlength=nrows)
    cl = np.bincount(c, minlength=ncols)
    out["row_len"] = {
        "mean": float(rl.mean()),
        "p50": int(np.percentile(rl, 50)),
        "p90": int(np.percentile(rl, 90)),
        "p99": int(np.percentile(rl, 99)),
        "max": int(rl.max()),
        "empty": int((rl == 0).sum()),
    }
    out["col_len"] = {
        "mean": float(cl.mean()),
        "max": int(cl.max()),
        "empty": int((cl == 0).sum()),
    }
    spread = np.abs(r.astype(np.int64) - c.astype(np.int64))
    out["bandwidth"] = {
        "p50": int(np.percentile(spread, 50)),
        "p90": int(np.percentile(spread, 90)),
        "max": int(spread.max()),
    }
    # TJDS metrics.
    out["tjds_diags"] = int(cl.max())
    return out


def format_analysis(stats: Dict) -> str:
    """Human-readable rendering of :func:`analyze` output."""
    lines = [
        f"shape {stats['shape'][0]}x{stats['shape'][1]}  nnz {stats['nnz']}"
        f"  density {stats['density']:.2e}",
    ]
    if "row_len" in stats:
        r = stats["row_len"]
        lines.append(
            f"row len: mean {r['mean']:.1f}  p50 {r['p50']}  p90 {r['p90']}"
            f"  p99 {r['p99']}  max {r['max']}  empty {r['empty']}"
        )
        b = stats["bandwidth"]
        lines.append(
            f"bandwidth |r-c|: p50 {b['p50']}  p90 {b['p90']}  max {b['max']}"
        )
        lines.append(f"TJDS diagonals: {stats['tjds_diags']}")
    return "\n".join(lines)
