"""DIA SpMV: the gather-free diagonal executor.

The irregular access of SpMV (``x[col]`` in the CSR dual of the
reference's scattered ``y[rowInd] +=``, SURVEY.md §2.4) disappears for
diagonal nonzeros: column ``r + off`` is the row shifted by a *constant*,
so each diagonal reads one contiguous slice of the padded x vector and the
only per-nonzero stream left is the 4 B/nnz value stream (half the
8 B/nnz a CSR-format executor must move):

    y = sum_d vals[d] * x_pad[pad_left + off_d : pad_left + off_d + rows]

over static slices, which XLA fuses into one loop.  y needs no fixup:
rows stay in natural order.
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp

from ..formats.dia import DiaPlan
from ..utils import platform

Array = Any


def _compute_dtype(vals_dtype):
    """Accumulate bf16 value streams in f32 (mixed precision: the value
    stream halves to 2 B/nnz, x and the accumulator stay full width)."""
    if jnp.dtype(vals_dtype) == jnp.bfloat16:
        return jnp.float32
    return vals_dtype


def _padded(plan: DiaPlan, x: Array, dtype, n: int) -> Array:
    """x with ``pad_left`` zeros in front and enough behind that every
    diagonal's slice of ``n`` rows stays in bounds."""
    cols = plan.shape[1]
    omax = max(max(plan.offsets, default=0), 0)
    right = max(n + omax, cols) - cols
    return jnp.pad(jnp.asarray(x, dtype), (plan.pad_left, right))


def _diag_slices(plan: DiaPlan, xp: Array, n: int):
    """Per diagonal k: the (T, S*128) x window its values multiply."""
    T = plan.vals.shape[0]
    for o in plan.offsets:
        start = plan.pad_left + o
        yield jax.lax.slice(xp, (start,), (start + n,)).reshape(T, -1)


def dia_sum(vals: Array, xp: Array, starts) -> Array:
    """``sum_k vals[:, k] * xp[starts[k] : starts[k] + n]`` over the
    (T, D, S, 128) value layout, as one fused loop; returns the flat
    (n,) result in the accumulation dtype.  ``starts`` are static."""
    T, D, S, R = vals.shape
    n = T * S * R
    acc = _compute_dtype(vals.dtype)
    v = vals.reshape(T, D, S * R)
    y = None
    for k, start in enumerate(starts):
        xs = jax.lax.slice(xp, (start,), (start + n,)).reshape(T, -1)
        term = v[:, k].astype(acc) * xs.astype(acc)
        y = term if y is None else y + term
    return y.reshape(-1)


@jax.jit
def _spmv_dia(plan: DiaPlan, x: Array) -> Array:
    T, D, S, R = plan.vals.shape
    xp = _padded(plan, x, _compute_dtype(plan.vals.dtype), T * S * R)
    starts = tuple(plan.pad_left + o for o in plan.offsets)
    return dia_sum(plan.vals, xp, starts)[:plan.shape[0]]


def spmv_dia(plan: DiaPlan, x: Array) -> Array:
    """``y = A @ x`` from a prebuilt :class:`DiaPlan`."""
    if plan.double:
        raise ValueError("double-float plan: use spmv_dia_double (f64 "
                         "host API) or spmv_dia_df (hi/lo pair, "
                         "jit-composable)")
    platform.route()
    return _spmv_dia(plan, jnp.asarray(x))


@jax.jit
def spmv_dia_df(plan: DiaPlan, xh: Array, xl: Array):
    """df64 SpMV from a double DiaPlan: (xh, xl) f32 pair in, (yh, yl)
    f32 pair out — jit-composable; use :func:`spmv_dia_double` for the
    float64-in/float64-out host convenience wrapper.  Values arrive as
    (hi, lo) f32 channel pairs (``vals[:, :D]`` / ``vals[:, D:]``);
    products and the accumulator use error-free transformations
    (``ops/df64.py``), so the result carries ~2^-48 relative error —
    precision parity with the reference's double-precision datapath
    (``SemiringOp.scala:98-154``)."""
    from . import df64

    T, D2, S, R = plan.vals.shape
    D = D2 // 2
    n = T * S * R
    v = plan.vals.reshape(T, D2, S * R)
    xph = _padded(plan, xh, jnp.float32, n)
    xpl = _padded(plan, xl, jnp.float32, n)
    acc_h = jnp.zeros((T, S * R), jnp.float32)
    acc_l = jnp.zeros((T, S * R), jnp.float32)
    for k, (sh, sl) in enumerate(zip(_diag_slices(plan, xph, n),
                                     _diag_slices(plan, xpl, n))):
        vh, vl = v[:, k], v[:, D + k]
        ph, pe = df64.two_prod(vh, sh)
        pe = pe + (vh * sl + vl * sh)
        ph, pe = df64.quick_two_sum(ph, pe)
        acc_h, acc_l = df64.add(acc_h, acc_l, ph, pe)
    rows = plan.shape[0]
    return acc_h.reshape(-1)[:rows], acc_l.reshape(-1)[:rows]


def spmv_dia_double(plan: DiaPlan, x):
    """``y = A @ x`` in f64-equivalent precision: float64 x in, float64 y
    out (computed as hi/lo f32 pairs on device, joined on the host)."""
    import numpy as np

    from . import df64

    if not plan.double:
        raise ValueError("plan was not built with value_dtype=np.float64")
    platform.route()
    xh, xl = df64.split_f64(x)
    yh, yl = spmv_dia_df(plan, xh, xl)
    return df64.join_f64(np.asarray(yh), np.asarray(yl))
