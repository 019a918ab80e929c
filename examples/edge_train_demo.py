#!/usr/bin/env python
"""Learn the edge values of a sparse operator by autodiff of the SpMV.

The reference toolkit stops at y = A·x with fixed values
(main-cli.c:410-416); here the CSR values are a trainable parameter:
``f(v, x) = spmv_csr(A with values v, x)`` is differentiable in both
arguments through JAX's own autodiff (a gather for d/dv, a scatter-add
for Aᵀg). This demo recovers hidden edge weights from (x, y)
observations with optax Adam — the attention-free cousin of learned
graph edge weighting.
"""
import dataclasses
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np
import optax

from smvp_toolkit_tpu.formats.csr import csr_encode
from smvp_toolkit_tpu.ops import spmv_csr
from smvp_toolkit_tpu.utils.synth import synth_banded

# A sparse operator with SECRET edge values the model must recover.
csr = csr_encode(synth_banded(1500, nnz_per_row=6, bandwidth=48, seed=0))
v_true = csr.vals


def f(v, x):
    """A(v)·x — the sparsity pattern fixed, the values live."""
    return spmv_csr(dataclasses.replace(csr, vals=v), x)


# Observations: y_i = A(v_secret)·x_i for random probes x_i.
rng = np.random.default_rng(1)
X = jnp.asarray(rng.standard_normal((16, csr.shape[1])).astype(np.float32))
fm = jax.vmap(f, in_axes=(None, 0))  # batch over probes
Y = fm(v_true, X)


def loss(v):
    return jnp.mean((fm(v, X) - Y) ** 2)


tx = optax.adam(2e-2)
v = jnp.zeros_like(v_true)           # start from no edges at all
state = tx.init(v)


@jax.jit
def step(v, state):
    val, g = jax.value_and_grad(loss)(v)
    updates, state = tx.update(g, state, v)
    return optax.apply_updates(v, updates), state, val


for i in range(1000):
    v, state, l = step(v, state)
    if i % 250 == 0:
        print(f"step {i:4d}  loss {float(l):.3e}")

rel = float(jnp.abs(v - v_true).max() / jnp.abs(v_true).max())
print(f"final loss {float(loss(v)):.3e}  max edge error {rel:.3f}")
