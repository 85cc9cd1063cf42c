"""SpMM (sparse x dense, multi-RHS) over SELL tile plans.

BASELINE.json config 3.  The SpMV gather-reduce executor with a trailing
RHS axis: every slot gathers one row of B, so the value and column streams
are read once for all k right-hand sides — the point of a fused SpMM.
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp

from ..formats.plan import SellPlan
from ..utils import platform
from .spmv_exec import _compute_dtype

Array = Any


def sell_spmm_partials(vals: Array, cols: Array, b: Array) -> Array:
    """(T, P, R) tiles x B (cols, k) -> (T, R, k) per-tile sums: a
    multiply and a reduction over P (no dot, so no TF32 rounding)."""
    acc = _compute_dtype(vals.dtype)
    bg = jnp.take(jnp.asarray(b, acc), cols, axis=0, mode="clip")
    return jnp.sum(vals.astype(acc)[..., None] * bg, axis=1)


@jax.jit
def _spmm_sell(plan: SellPlan, b: Array) -> Array:
    """b: (cols, k); returns y (rows, k)."""
    k = b.shape[1]
    contrib = sell_spmm_partials(plan.vals, plan.cols, b)
    y3d = jax.ops.segment_sum(contrib, jnp.asarray(plan.tile_slice),
                              num_segments=plan.num_slices,
                              indices_are_sorted=True)     # (S, R, k)
    flat = y3d.reshape(-1, k)
    rows = plan.shape[0]
    if plan.identity_map:
        return flat[:rows]
    return jax.ops.segment_sum(flat, jnp.asarray(plan.row_map),
                               num_segments=rows + 1)[:rows]


def spmm_supported(plan) -> bool:
    """Whether :func:`spmm_plan` has an executor for this plan family."""
    from ..formats.cached import CooTail
    from ..formats.dia import DiaPlan, HybridPlan

    if isinstance(plan, HybridPlan):
        return spmm_supported(plan.dia) and spmm_supported(plan.rest)
    if isinstance(plan, DiaPlan):
        return not plan.double
    if isinstance(plan, SellPlan):
        return not plan.stats.double
    return isinstance(plan, CooTail)


def spmm_plan(plan, b: Array) -> Array:
    """SpMM ``Y = A @ B`` from a prebuilt plan (B: (cols, k)).

    Dispatches on plan type like :func:`.spmv_exec.spmv_plan`; raises
    ValueError for plan families without an SpMM executor (chunk, cached
    and double-float plans, see :func:`spmm_supported`)."""
    from ..formats.cached import CooTail
    from ..formats.dia import DiaPlan, HybridPlan
    from .spmm_dia import spmm_dia

    platform.route()
    if not spmm_supported(plan):
        raise ValueError(f"no SpMM executor for {type(plan).__name__}; "
                         f"use the reference spmm path")
    if isinstance(plan, CooTail):
        bd = jnp.asarray(b)
        prod = plan.vals[:, None].astype(bd.dtype) * \
            jnp.take(bd, plan.cols, axis=0, mode="clip")
        rows = plan.shape[0]
        y = jax.ops.segment_sum(prod, plan.rows_idx,
                                num_segments=rows + 1)
        return y[:rows]
    if isinstance(plan, DiaPlan):
        return spmm_dia(plan, b)
    if isinstance(plan, HybridPlan):
        return spmm_plan(plan.dia, b) + spmm_plan(plan.rest, b)
    return _spmm_sell(plan, jnp.asarray(b))
