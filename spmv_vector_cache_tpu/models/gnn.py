"""Graph neural network building blocks on the SpMM kernels.

A GCN layer is exactly the library's SpMM against the normalized adjacency
(``H' = act(Â H W)``): the sparse aggregate rides the SpMM path (the
dense feature transform is a matrix product), demonstrating the kernels inside a
learnable model with grad support.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..formats.containers import CSR
from ..formats.convert import coo_to_csr, csr_to_coo
from ..ops import reference

Array = Any


def normalized_adjacency(adj: CSR, add_self_loops: bool = True) -> CSR:
    """Symmetric GCN normalization D^-1/2 (A + I) D^-1/2 (host-side prep)."""
    coo = csr_to_coo(adj)
    row = np.asarray(coo.row)
    col = np.asarray(coo.col)
    val = np.ones_like(np.asarray(coo.data), dtype=np.float32)
    n = adj.shape[0]
    if add_self_loops:
        row = np.concatenate([row, np.arange(n, dtype=row.dtype)])
        col = np.concatenate([col, np.arange(n, dtype=col.dtype)])
        val = np.concatenate([val, np.ones(n, np.float32)])
    deg = np.bincount(row, weights=val, minlength=n)
    dinv = 1.0 / np.sqrt(np.maximum(deg, 1e-12))
    val = val * dinv[row] * dinv[col]
    from ..formats.containers import COO
    return coo_to_csr(COO(data=val.astype(np.float32),
                          row=row.astype(np.int32), col=col.astype(np.int32),
                          shape=adj.shape))


def gcn_layer(a_norm, h: Array, w: Array, b: Optional[Array] = None,
              activation: Callable[[Array], Array] = jax.nn.relu,
              spmm: Optional[Callable] = None) -> Array:
    """One GCN layer: ``act(Â @ (H W) + b)``.

    ``spmm``: override the sparse aggregate (e.g. the sharded executor);
    defaults to the library SpMM reference path.
    """
    hw = jnp.dot(h, w, preferred_element_type=h.dtype,
                 precision=jax.lax.Precision.HIGHEST)
    agg = (spmm or (lambda a, m: reference.spmm(a, m)))(a_norm, hw)
    if b is not None:
        agg = agg + b
    return activation(agg)


def init_gcn_params(key, sizes, dtype=jnp.float32):
    """Glorot-initialized (W, b) per layer for sizes [in, h1, ..., out]."""
    params = []
    for i in range(len(sizes) - 1):
        key, sub = jax.random.split(key)
        lim = jnp.sqrt(6.0 / (sizes[i] + sizes[i + 1]))
        w = jax.random.uniform(sub, (sizes[i], sizes[i + 1]), dtype,
                               -lim, lim)
        params.append((w, jnp.zeros((sizes[i + 1],), dtype)))
    return params


def gcn_forward(a_norm, x: Array, params, spmm: Optional[Callable] = None
                ) -> Array:
    """Multi-layer GCN forward; last layer linear (logits)."""
    h = x
    for i, (w, b) in enumerate(params):
        act = jax.nn.relu if i < len(params) - 1 else (lambda z: z)
        h = gcn_layer(a_norm, h, w, b, activation=act, spmm=spmm)
    return h
