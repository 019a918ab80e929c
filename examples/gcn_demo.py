#!/usr/bin/env python
"""Graph convolution on a sample matrix — SpMM + dense layers end to end.

Treats the ibm32 stand-in's sparsity pattern as a graph
(``utils.synth.sample_matrix``), builds the Kipf-Welling
normalized adjacency, and trains a 2-layer GCN to classify nodes by
their row-degree parity (a toy label that needs neighborhood info).
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np

from smvp_toolkit_tpu.models import gcn_init, gcn_norm, gcn_train_step
from smvp_toolkit_tpu.utils.synth import sample_matrix

coo = sample_matrix("ibm32")
n = coo.shape[0]
s = gcn_norm(coo)

r, c, v = coo.to_numpy()
deg = np.bincount(r, minlength=n)
labels = jnp.asarray((deg % 2).astype(np.int32))
h = jnp.asarray(np.random.RandomState(0).randn(n, 8).astype(np.float32))
params = gcn_init(jax.random.PRNGKey(0), [8, 16, 2])
mask = jnp.ones((n,), jnp.float32)


@jax.jit
def train(p):
    def body(p, _):
        p, loss = gcn_train_step(s, p, h, labels, mask, lr=0.1)
        return p, loss

    return jax.lax.scan(body, p, None, length=100)


params, losses = train(params)
print(f"loss: {float(losses[0]):.3f} -> {float(losses[-1]):.3f}")
