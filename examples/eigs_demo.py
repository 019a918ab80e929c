#!/usr/bin/env python
"""Smallest eigenpairs of a 2-D Laplacian: LOBPCG + AMG + k-wide SpMM.

The block eigensolver's multiplies are k-wide SpMMs (gather +
segment-sum), the preconditioner is the smoothed-aggregation V-cycle,
and the Ritz values land on the
analytic Dirichlet-Laplacian spectrum 4sin²(iπ/2(nx+1)) + 4sin²(jπ/2(nx+1)).
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import scipy.sparse as sp

import jax.numpy as jnp

from smvp_toolkit_tpu import csr_encode
from smvp_toolkit_tpu.formats.coo import COOMatrix
from smvp_toolkit_tpu.models import amg_preconditioner, lobpcg

NX, K, ITERS = 40, 4, 40

n = NX * NX
eye = sp.eye(NX)
t = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], (NX, NX))
a = (sp.kron(eye, t) + sp.kron(t, eye)).tocoo()
coo = COOMatrix.from_numpy(
    a.row.astype(np.int32), a.col.astype(np.int32),
    a.data.astype(np.float32), shape=(n, n), pad_to=128,
)
csr = csr_encode(coo)

m = amg_preconditioner(csr)                # V-cycle preconditioner
X0 = jnp.asarray(
    np.random.RandomState(0).standard_normal((n, K)).astype(np.float32)
)
theta, X, res = lobpcg(csr, X0, num_iters=ITERS, m=m)

s = np.sin(np.arange(1, NX + 1) * np.pi / (2 * (NX + 1))) ** 2
analytic = np.sort((4 * s[:, None] + 4 * s[None, :]).ravel())[:K]
print(f"2-D Dirichlet Laplacian {NX}x{NX}, {K} smallest eigenvalues, "
      f"{ITERS} LOBPCG iterations (AMG-preconditioned):")
for j, (th, an, r) in enumerate(
    zip(np.asarray(theta), analytic, np.asarray(res)[-1])
):
    print(f"  λ{j}: {th:.6f}  (analytic {an:.6f}, residual {r:.1e})")
