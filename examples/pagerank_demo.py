#!/usr/bin/env python
"""PageRank over a sample sparse matrix — library usage example."""
import sys, os
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from smvp_toolkit_tpu import csr_encode
from smvp_toolkit_tpu.models import pagerank
from smvp_toolkit_tpu.utils.synth import sample_matrix

coo = sample_matrix("ibm32").pad(128)
# Column-normalize so the link matrix is column-stochastic.
r, c, v = coo.to_numpy()
colsum = np.bincount(c, weights=v, minlength=coo.shape[1])
v_norm = v / np.where(colsum[c] > 0, colsum[c], 1.0)
from smvp_toolkit_tpu.formats.coo import COOMatrix
coo_n = COOMatrix.from_numpy(r, c, v_norm, shape=coo.shape, pad_to=128)

rank = np.asarray(pagerank(csr_encode(coo_n), num_iters=100))
top = np.argsort(-rank)[:5]
print("top-5 nodes:", top.tolist())
print("ranks:", np.round(rank[top], 4).tolist())
