#!/usr/bin/env python
"""The preconditioner ladder on a 2-D Poisson system.

Shows the whole family on one SPD problem: plain CG, Jacobi scaling,
truncated-Neumann polynomial, SSOR, block-Jacobi (batched dense block
inverses), IC(0) (host-factored, fixed-sweep Neumann trisolves), and
smoothed-aggregation AMG (host-built hierarchy, fixed-shape V-cycle).
Every preconditioner cuts the plain-CG iteration count to a 1e-6
relative residual (124 → 42 for IC(0), → 10 for AMG — and AMG's
count stays ~10 as the grid grows, where every one-level method
degrades).
The one-level ordering is not strictly monotone down the ladder:
block-Jacobi (97) trails SSOR (47) on this stencil because a 5-point
Poisson row couples two grid lines while each dense block spans only
one. ARCHITECTURE.md §5b says why the applies are shaped as fixed-shape
device programs.
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from smvp_toolkit_tpu import csr_encode
from smvp_toolkit_tpu.formats.coo import COOMatrix
from smvp_toolkit_tpu.models import (
    amg_preconditioner,
    block_jacobi_preconditioner,
    conjugate_gradient,
    ic0_preconditioner,
    jacobi_preconditioner,
    pcg_precond,
    ssor_preconditioner,
)
from smvp_toolkit_tpu.ops.algebra import diagonal
from smvp_toolkit_tpu.ops.ilu import ic0

NX = 48
TOL = 1e-6

n = NX * NX
rows, cols, vals = [], [], []
for i in range(NX):
    for j in range(NX):
        k = i * NX + j
        rows.append(k), cols.append(k), vals.append(4.0)
        for dk in (-NX, -1):
            if (dk == -NX and i > 0) or (dk == -1 and j > 0):
                rows += [k, k + dk]
                cols += [k + dk, k]
                vals += [-1.0, -1.0]
r = np.asarray(rows, np.int32)
c = np.asarray(cols, np.int32)
v = np.asarray(vals, np.float64)
order = np.lexsort((c, r))
coo = COOMatrix.from_numpy(r[order], c[order], v[order], shape=(n, n),
                           pad_to=128)
csr = csr_encode(coo)
b = np.random.RandomState(0).randn(n).astype(np.float32)
b_norm = float(np.linalg.norm(b))
d = diagonal(coo)

ladder = {
    "cg (none)": None,
    "jacobi": lambda rr: (1.0 / d) * rr,
    "neumann o3": jacobi_preconditioner(csr, d, order=3),
    "ssor s4": ssor_preconditioner(csr, sweeps=4),
    "block-jacobi 48": block_jacobi_preconditioner(csr, block=NX),
    "ic0 s4": ic0_preconditioner(ic0(csr), sweeps=4),
    "amg v(1,1)": amg_preconditioner(csr),
}
print(f"2-D Poisson {NX}x{NX} (n={n}) -> relative residual {TOL}")
for name, m in ladder.items():
    if m is None:
        _, res = conjugate_gradient(csr, b, num_iters=400, tol=TOL)
    else:
        _, res = pcg_precond(csr, b, m, num_iters=400, tol=TOL)
    ok = np.asarray(res) / b_norm < TOL
    iters = int(np.argmax(ok)) + 1 if ok.any() else ">400"
    print(f"  {name:16s} {iters:>4} iterations")
