#!/usr/bin/env python
"""Encode-once / serve-many: matrix checkpoint -> reload -> solver loop.

The production deployment pattern: parsing and encoding happen once at
ingest; serving hosts load the encoded CSR and run iterated SpMV
entirely on device.
"""
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax.numpy as jnp
import numpy as np

from smvp_toolkit_tpu.formats.csr import csr_encode
from smvp_toolkit_tpu.models import power_iteration
from smvp_toolkit_tpu.utils.checkpoint import load_matrix, save_matrix
from smvp_toolkit_tpu.utils.synth import sample_matrix

# --- ingest side: generate (stand-in for parsing), encode, checkpoint ---
coo = sample_matrix("memplus").pad(512)
ckpt = os.path.join(tempfile.gettempdir(), "memplus_csr.npz")
save_matrix(ckpt, csr_encode(coo))
print(f"CSR checkpoint: {ckpt} ({os.path.getsize(ckpt)/1e6:.1f} MB)")

# --- serving side: reload, iterate on device ---
csr = load_matrix(ckpt)
x0 = jnp.ones((coo.shape[1],), jnp.float32)
lam, vec = power_iteration(csr, x0, num_iters=50)
print(f"dominant |eigenvalue| estimate: {float(lam):.6g}")

# --- alternative serving artifact: AOT-exported compiled program ---
# The XLA program itself (matrix baked in) becomes the artifact; the
# serving process needs only jax — no framework import.
from smvp_toolkit_tpu.utils.aot import export_spmv, import_program

blob = export_spmv(csr)
aot_path = os.path.join(tempfile.gettempdir(), "memplus_spmv.jaxexport")
with open(aot_path, "wb") as f:
    f.write(blob)
print(f"AOT artifact: {aot_path} ({len(blob)/1e6:.1f} MB)")
call = import_program(blob)
y = np.asarray(call(jnp.ones((coo.shape[1],), jnp.float32)))
print(f"served y checksum: {y.sum():.6g}")
