"""Graph neural layers on the sparse SpMV/SpMM engine.

The reference toolkit stops at y = A·x (main-cli.c:410-416); the natural
production consumer of a sparse engine on an accelerator is graph
learning, where the hot op is S·H for a normalized adjacency S and a
dense feature block H. These layers compose the framework's SpMM with
dense matrix products, fully jit-compiled:

* feature transform H·W — a dense matrix product,
* neighborhood aggregation S·(HW) — the sparse engine's SpMM,
* training loop — `lax.scan` over jitted value_and_grad steps (no host
  round trips; SpMM is linear so autodiff flows through the XLA kernels
  out of the box).

``gcn_norm`` builds the symmetric normalization D^-1/2 (A + I) D^-1/2 of
Kipf & Welling from COO triplets (host numpy, encode-time).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from smvp_toolkit_tpu.formats.coo import COOMatrix
from smvp_toolkit_tpu.formats.csr import CSRMatrix, csr_encode
from smvp_toolkit_tpu.ops.spmv_xla import spmm_csr

__all__ = [
    "gcn_norm",
    "gcn_layer",
    "gcn_forward",
    "gcn_train_step",
    "gcn_train_step_edges",
    "gcn_init",
]


def gcn_norm(coo: COOMatrix, *, add_self_loops: bool = True) -> CSRMatrix:
    """Symmetrically-normalized adjacency D^-1/2 (A + I) D^-1/2 as CSR.

    Edge weights are rectified (``abs``) before normalization: the
    degrees under the square root must be non-negative, and the GCN
    convention (Kipf & Welling) assumes non-negative adjacency. A
    signed graph therefore loses its signs here — normalize it yourself
    if the signs are semantic.
    """
    if coo.shape[0] != coo.shape[1]:
        raise ValueError("gcn_norm needs a square adjacency")
    n = coo.shape[0]
    r, c, v = coo.to_numpy()
    v = np.abs(np.asarray(v, dtype=np.float64))
    if add_self_loops:
        r = np.concatenate([r, np.arange(n, dtype=r.dtype)])
        c = np.concatenate([c, np.arange(n, dtype=c.dtype)])
        v = np.concatenate([v, np.ones(n)])
    deg = np.zeros(n)
    np.add.at(deg, r, v)
    dinv = 1.0 / np.sqrt(np.maximum(deg, 1e-12))
    vn = dinv[r] * v * dinv[c]
    return csr_encode(
        COOMatrix.from_numpy(
            r.astype(np.int32), c.astype(np.int32), vn, shape=coo.shape,
            pad_to=128,
        )
    )


def gcn_layer(
    s: CSRMatrix,
    h: jax.Array,
    w: jax.Array,
    b: Optional[jax.Array] = None,
    act: Callable[[jax.Array], jax.Array] = jax.nn.relu,
    *,
    spmm: Optional[Callable] = None,
) -> jax.Array:
    """One GCN layer: act(S · (H W) + b).

    Transform-then-aggregate: the dense H·W runs first so the
    SpMM aggregates the (usually narrower) output width.

    ``spmm``: injectable aggregation kernel ``(s, hw) -> S·hw`` — pass
    e.g. ``lambda m, z: spmm_csr_sharded(sharded, z, mesh)`` to train
    data-parallel (shard_map is differentiable, so gradients flow
    through the collective: the forward's ordered all-gather transposes
    to a reduce-scatter of the cotangent). Defaults to the single-chip
    XLA kernel.
    """
    # Full f32: a default-precision product may run in TF32 on a GPU.
    hw = jnp.matmul(h, w, precision=jax.lax.Precision.HIGHEST)
    out = (spmm or spmm_csr)(s, hw)
    if b is not None:
        out = out + b
    return act(out)


def gcn_init(
    key: jax.Array, dims: Sequence[int]
) -> List[Tuple[jax.Array, jax.Array]]:
    """Glorot-initialized (W, b) pairs for ``len(dims) - 1`` layers."""
    params = []
    for din, dout in zip(dims[:-1], dims[1:]):
        key, sub = jax.random.split(key)
        scale = jnp.sqrt(2.0 / (din + dout))
        params.append(
            (
                jax.random.normal(sub, (din, dout), jnp.float32) * scale,
                jnp.zeros((dout,), jnp.float32),
            )
        )
    return params


def gcn_forward(
    s: CSRMatrix, params, h: jax.Array, *, spmm: Optional[Callable] = None
) -> jax.Array:
    """Multi-layer GCN; last layer linear (logits)."""
    for i, (w, b) in enumerate(params):
        last = i == len(params) - 1
        h = gcn_layer(
            s, h, w, b, act=(lambda z: z) if last else jax.nn.relu,
            spmm=spmm,
        )
    return h


def gcn_train_step(
    s: CSRMatrix,
    params,
    h: jax.Array,
    labels: jax.Array,
    mask: jax.Array,
    lr: float = 1e-2,
    *,
    spmm: Optional[Callable] = None,
):
    """One SGD step on masked softmax cross-entropy; returns (params, loss).

    Jittable: wrap in ``jax.jit`` (s is a pytree of static-shaped device
    arrays) or scan it for a full training run. With an injected sharded
    ``spmm`` (see :func:`gcn_layer`) this is the full data-parallel
    training step: replicated parameters, row-block-sharded aggregation,
    gradients reduced by the shard_map transpose.
    """

    def loss_fn(p):
        logits = gcn_forward(s, p, h, spmm=spmm)
        logp = jax.nn.log_softmax(logits)
        nll = -jnp.take_along_axis(logp, labels[:, None], axis=1)[:, 0]
        m = mask.astype(logp.dtype)
        return (nll * m).sum() / jnp.maximum(m.sum(), 1.0)

    loss, grads = jax.value_and_grad(loss_fn)(params)
    new_params = jax.tree_util.tree_map(lambda p, g: p - lr * g, params, grads)
    return new_params, loss


def gcn_train_step_edges(
    s: CSRMatrix,
    params,
    edge_vals: jax.Array,
    h: jax.Array,
    labels: jax.Array,
    mask: jax.Array,
    lr: float = 1e-2,
    edge_lr: Optional[float] = None,
    *,
    spmm: Optional[Callable] = None,
):
    """One SGD step training the layer weights AND the edge weights.

    ``edge_vals`` is the live values plane of the aggregation operator,
    in ``s.vals`` layout (CSR entry order; pass ``s.vals`` to start).
    SpMM is bilinear in (values, features), so the edge cotangent flows
    through the XLA kernels out of the box — learned edge weighting
    (the attention-free cousin of GAT) costs one extra gradient, no new
    kernels. Entries padded past ``s.nnz`` aggregate into no row, so
    their gradient is exactly 0 and they stay put under SGD.

    ``spmm``: injectable aggregation ``(m, z) -> A·z`` receiving the
    live-valued matrix ``m`` — for DISTRIBUTED edge training pass
    ``lambda m, z: spmm_csr_sharded(s_sh.with_vals(m.vals), z, mesh)``:
    `ShardedCSR.with_vals` rebuilds the per-shard slab from the live
    entry-order values inside the trace, so the edge cotangent flows
    back through the shard_map collective.

    Returns ``(params, edge_vals, loss)``.
    """
    import dataclasses

    edge_lr = lr if edge_lr is None else edge_lr

    def loss_fn(p, ev):
        logits = gcn_forward(
            dataclasses.replace(s, vals=ev), p, h, spmm=spmm
        )
        logp = jax.nn.log_softmax(logits)
        nll = -jnp.take_along_axis(logp, labels[:, None], axis=1)[:, 0]
        m = mask.astype(logp.dtype)
        return (nll * m).sum() / jnp.maximum(m.sum(), 1.0)

    loss, (gp, ge) = jax.value_and_grad(loss_fn, argnums=(0, 1))(
        params, edge_vals
    )
    new_params = jax.tree_util.tree_map(lambda p, g: p - lr * g, params, gp)
    return new_params, edge_vals - edge_lr * ge, loss
