"""DIA SpMM: the multi-RHS diagonal executor.

Extends :mod:`.spmv_dia` to ``Y = A @ B`` with k right-hand sides: each
diagonal multiplies one contiguous row slice of the padded B, so the value
stream is read once for all k columns (4 B/nnz + the dense operands).
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp

from ..formats.dia import DiaPlan
from ..utils import platform
from .spmv_dia import _compute_dtype

Array = Any


@jax.jit
def _spmm_dia(plan: DiaPlan, b: Array) -> Array:
    """b: (cols, k); returns y (rows, k)."""
    T, D, S, R = plan.vals.shape
    rows, cols = plan.shape
    n = T * S * R
    k = b.shape[1]
    acc = _compute_dtype(plan.vals.dtype)
    omax = max(max(plan.offsets, default=0), 0)
    bp = jnp.pad(jnp.asarray(b, acc),
                 ((plan.pad_left, max(n + omax, cols) - cols), (0, 0)))
    v = plan.vals.reshape(T, D, S * R)
    y = None
    for d, o in enumerate(plan.offsets):
        start = plan.pad_left + o
        bs = jax.lax.slice(bp, (start, 0), (start + n, k))
        term = v[:, d].reshape(n, 1).astype(acc) * bs
        y = term if y is None else y + term
    return y[:rows]


def spmm_dia(plan: DiaPlan, b: Array) -> Array:
    """DIA SpMM ``Y = A @ B`` (B: (cols, k))."""
    if plan.double:
        raise ValueError("double-float DIA plans have no SpMM executor")
    platform.route()
    return _spmm_dia(plan, jnp.asarray(b))
