"""SpMV executors over SELL tile plans, and the public plan dispatcher.

This is the accelerator datapath of the library — the role of the
reference's frontend/backend RTL (``chisel/backend/SpMVBackend.scala``,
``chisel/frontend/SpMVFrontend*.scala``).  On the GPU the irregular access
of the CSR dual (``x[col]``) is a plain gather served by the L1/L2 caches,
so one executor serves every SELL layout:

* the SELL layout binds rows to the 128-lane axis of each (P, 128) tile,
  so ``y[row] +=`` is a reduction over the P positions of a tile — a
  gather, a multiply and a reduction that XLA fuses into one loop;
* the tile -> slice fold is a sorted segment reduction, and the plan's
  ``row_map`` fixup merges split/sigma/stripe sub-rows back into y (or a
  contiguous lane fold for uniform split layouts, or nothing at all when
  the plan's row order is the identity).

The plan arrays that only served window-shaped kernels (``cols_win``,
``window_base``, ``window_rows``) are carried but unused here.
"""

from __future__ import annotations

import functools
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from ..formats.plan import SellPlan
from ..utils import platform

Array = Any


def _compute_dtype(vals_dtype):
    """Mixed precision: bf16 value streams gather/accumulate in f32 (the
    value channel halves to 2 B/nnz — the same discipline as the DIA
    executor's bf16 path, ``spmv_dia._compute_dtype``)."""
    if jnp.dtype(vals_dtype) == jnp.bfloat16:
        return jnp.float32
    return jnp.dtype(vals_dtype)


def _fixup_rows(plan: SellPlan, y2d: Array, semiring: str) -> Array:
    """(num_slices, R) slice sums -> y: identity slice, uniform-parts
    lane fold, or the general row_map segment reduce."""
    from . import semiring as sr

    rows = plan.shape[0]
    if plan.identity_map:
        return y2d.reshape(-1)[:rows]
    s = sr.get(semiring)
    p = plan.stats.uniform_parts
    if p:
        # uniform split layouts are part-major within each slice (part j
        # of row r at lane j*rps + r%rps): the fixup is a fold of
        # contiguous lane slices, no scatter
        rps = plan.lane_rows // p
        acc = y2d[:, :rps]
        for j in range(1, p):
            acc = s.add(acc, y2d[:, j * rps:(j + 1) * rps])
        # or_and's logical add yields bool; restore the float encoding
        return acc.astype(y2d.dtype).reshape(-1)[:rows]
    y = s.segment_reduce(y2d.reshape(-1), jnp.asarray(plan.row_map),
                         num_segments=rows + 1)
    return y[:rows]


def _reduce_partials(plan: SellPlan, partials: Array,
                     semiring: str = "plus_times") -> Array:
    """Per-tile rows (T, R) -> y.  Uniformly tiled plans (every slice
    exactly ``group_tiles`` tiles, ``stats.group_slice_identity``) fold
    tiles to slices with a reshape; otherwise a sorted segment reduction
    over ``tile_slice``.  Then the sub-row fixup."""
    from . import semiring as sr

    st = plan.stats
    if st.group_slice_identity:
        _, axis_reduce = sr.kernel_ops(semiring)
        wg = st.group_tiles
        y2d = axis_reduce(partials.reshape(-1, wg, partials.shape[-1]),
                          1)[:plan.num_slices]
    else:
        y2d = sr.get(semiring).segment_reduce(
            partials, jnp.asarray(plan.tile_slice),
            num_segments=plan.num_slices, indices_are_sorted=True)
    return _fixup_rows(plan, y2d, semiring)


def _tile_partials(vals: Array, cols: Array, x: Array,
                   semiring: str) -> Array:
    """(T, P, R) value/column tiles -> (T, R) per-tile lane sums: the
    fused gather-multiply-reduce every SELL-shaped layout runs."""
    from . import semiring as sr

    mul, axis_reduce = sr.kernel_ops(semiring)
    acc = _compute_dtype(vals.dtype)
    xg = jnp.take(jnp.asarray(x, acc), cols, axis=0, mode="clip")
    return axis_reduce(mul(vals.astype(acc), xg), 1)


@functools.partial(jax.jit, static_argnames=("semiring",))
def _spmv_sell(plan: SellPlan, x: Array,
               semiring: str = "plus_times") -> Array:
    return _reduce_partials(
        plan, _tile_partials(plan.vals, plan.cols, x, semiring), semiring)


def lane_unpermute(y2d: Array, idx: Array) -> Array:
    """``out[p] = y2d[aligned 1024-window of p][idx[p]]``: undo the chunk
    plan's row sort, which never leaves an aligned window of 1024 rows
    (``formats/chunk.py``).  ``y2d``: (S, 128) with S a multiple of 8;
    ``idx``: (S, 128) int16 source offsets within the window."""
    S, R = y2d.shape
    if R != 128 or S % 8:
        raise ValueError(f"y2d must be (8k, 128), got {y2d.shape}")
    w = jnp.take_along_axis(y2d.reshape(S // 8, 1024),
                            jnp.asarray(idx, jnp.int32).reshape(S // 8, 1024),
                            axis=1)
    return w.reshape(S, R)


@functools.partial(jax.jit, static_argnames=("semiring",))
def _spmv_chunk(plan, x: Array, semiring: str = "plus_times") -> Array:
    """ChunkPlan: per-bucket tile partials over one unified segment space
    ([0, num_blocks) light row blocks, then heavy rows) -> ONE segment
    reduction -> lane un-permutation for the light part, lane fold +
    short sorted merge for the heavy part (``formats/chunk.py``)."""
    from . import semiring as sr

    s = sr.get(semiring)
    _, axis_reduce = sr.kernel_ops(semiring)
    nblk = plan.num_blocks
    nheavy = plan.num_heavy
    rows = plan.shape[0]
    parts, ids = [], []
    for b in plan.buckets:
        parts.append(_tile_partials(b.vals, b.cols, x, semiring))
        ids.append(jnp.asarray(b.tile_slice))
    for h in plan.hbuckets:
        # subwindow tiles store sublane-local offsets: rebuild the global
        # column of every slot from its sublane's window base
        cols = (jnp.asarray(h.bases, jnp.int32)[:, :, None] * 128
                + jnp.asarray(h.cols_win, jnp.int32))
        parts.append(_tile_partials(h.vals, cols, x, semiring))
        ids.append(jnp.asarray(h.tile_seg))
    y2d = s.segment_reduce(jnp.concatenate(parts), jnp.concatenate(ids),
                           num_segments=nblk + nheavy)
    y = lane_unpermute(y2d[:nblk], plan.perm_idx).reshape(-1)[:rows]
    if nheavy:
        yh = axis_reduce(y2d[nblk:], 1)            # (nheavy,)
        yh = s.segment_reduce(yh, jnp.asarray(plan.heavy_rows),
                              num_segments=rows + 1,
                              indices_are_sorted=True)[:rows]
        y = s.add(y, yh).astype(y.dtype)
    if plan.residue is not None:
        y = s.add(y, spmv_plan(plan.residue, x,
                               semiring=semiring)).astype(y.dtype)
    return y


# ---------------------------------------------------------------------------
# double-float (f64-parity) path
# ---------------------------------------------------------------------------

def _df_tile_partials(plan: SellPlan, xh: Array, xl: Array):
    """df64 gather + product + per-tile compensated pairwise reduction:
    (T, 2P, R) hi/lo value tiles -> (T, R) hi/lo tile sums with ~2^-48
    relative error (error-free transformations, ``ops/df64.py``)."""
    from . import df64

    P = plan.positions
    v = plan.vals
    vh, vl = v[:, :P], v[:, P:]
    gh = jnp.take(jnp.asarray(xh, jnp.float32), plan.cols, axis=0,
                  mode="clip")
    gl = jnp.take(jnp.asarray(xl, jnp.float32), plan.cols, axis=0,
                  mode="clip")
    ph, pe = df64.two_prod(vh, gh)
    pe = pe + (vh * gl + vl * gh)
    hh, ll = df64.quick_two_sum(ph, pe)
    m = P
    while m > 1:
        m //= 2
        hh, ll = df64.add(hh[:, :m], ll[:, :m], hh[:, m:2 * m],
                          ll[:, m:2 * m])
    return hh[:, 0], ll[:, 0]


def _df_slice_indices(plan: SellPlan):
    """Static (num_slices, max_tiles) tile-id matrix for the compensated
    slice reduction; id == T points at an appended zero tile."""
    ts = np.asarray(plan.tile_slice)
    T = ts.shape[0]
    starts = np.searchsorted(ts, np.arange(plan.num_slices + 1))
    counts = np.diff(starts)
    maxt = max(1, int(counts.max()))
    idx = starts[:-1, None] + np.arange(maxt)[None, :]
    idx = np.where(np.arange(maxt)[None, :] < counts[:, None], idx, T)
    return idx.astype(np.int32)


def _df_row_indices(plan: SellPlan):
    """Static (rows, max_parts) slot-id matrix for the compensated row
    fixup; id == num_slots points at an appended zero slot."""
    rm = np.asarray(plan.row_map)
    rows = plan.shape[0]
    n = rm.shape[0]
    order = np.argsort(rm, kind="stable")
    rs = rm[order]
    starts = np.searchsorted(rs, np.arange(rows + 1))
    counts = np.diff(starts)
    maxp = max(1, int(counts.max()))
    idx = np.full((rows, maxp), n, dtype=np.int64)
    for j in range(maxp):
        sel = counts > j
        idx[sel, j] = order[starts[:-1][sel] + j]
    return idx.astype(np.int32)


def spmv_sell_double_pair(plan: SellPlan, xh: Array, xl: Array):
    """``y = A @ x`` in f64-equivalent precision, fully on device:
    hi/lo f32 pair in, hi/lo f32 pair out — jit-composable (a df64 CG
    or power-iteration chain never syncs the host).  Products and the
    within-tile reduction use error-free transformations; the slice and
    row reductions run the compensated ``df64.add`` over statically
    planned index matrices, so precision stays ~2^-48 end to end — the
    device counterpart of the reference's DP datapath
    (``SemiringOp.scala:98-154``).

    Close the plan over (don't pass it as a traced jit argument): the
    fold shapes derive from the concrete ``tile_slice``/``row_map``."""
    from . import df64

    th, tl = _df_tile_partials(plan, xh, xl)
    R = plan.lane_rows
    rows = plan.shape[0]
    zrow = jnp.zeros((1, R), th.dtype)
    th = jnp.concatenate([th, zrow])
    tl = jnp.concatenate([tl, zrow])
    sidx = jnp.asarray(_df_slice_indices(plan))        # (S, maxT)
    maxt = sidx.shape[1]
    TH = jnp.take(th, sidx, axis=0)                    # (S, maxT, R)
    TL = jnp.take(tl, sidx, axis=0)

    def sbody(j, c):
        return df64.add(c[0], c[1], TH[:, j], TL[:, j])

    yh, yl = jax.lax.fori_loop(1, maxt, sbody, (TH[:, 0], TL[:, 0])) \
        if maxt > 1 else (TH[:, 0], TL[:, 0])
    if plan.identity_map:
        return yh.reshape(-1)[:rows], yl.reshape(-1)[:rows]
    p = plan.stats.uniform_parts
    if p:
        rps = R // p
        ah, al = yh[:, :rps], yl[:, :rps]
        for j in range(1, p):
            ah, al = df64.add(ah, al, yh[:, j * rps:(j + 1) * rps],
                              yl[:, j * rps:(j + 1) * rps])
        return ah.reshape(-1)[:rows], al.reshape(-1)[:rows]
    fh = jnp.concatenate([yh.reshape(-1), jnp.zeros((1,), yh.dtype)])
    fl = jnp.concatenate([yl.reshape(-1), jnp.zeros((1,), yl.dtype)])
    ridx = jnp.asarray(_df_row_indices(plan))          # (rows, maxp)
    FH = jnp.take(fh, ridx)                            # (rows, maxp)
    FL = jnp.take(fl, ridx)

    def rbody(j, c):
        return df64.add(c[0], c[1], FH[:, j], FL[:, j])

    maxp = ridx.shape[1]
    oh, ol = jax.lax.fori_loop(1, maxp, rbody, (FH[:, 0], FL[:, 0])) \
        if maxp > 1 else (FH[:, 0], FL[:, 0])
    return oh, ol


def spmv_sell_double(plan: SellPlan, x):
    """``y = A @ x`` in f64-equivalent precision from a double SELL plan:
    float64 x in, float64 y out.  The entire reduction chain runs on
    device (:func:`spmv_sell_double_pair`); the f64 join here is only
    the API boundary for host-precision callers."""
    from . import df64

    if not plan.stats.double:
        raise ValueError("plan was not built with value_dtype=np.float64")
    platform.route()
    xh, xl = df64.split_f64(x)
    fn = jax.jit(lambda a, b: spmv_sell_double_pair(plan, a, b))
    yh, yl = fn(jnp.asarray(xh), jnp.asarray(xl))
    return df64.join_f64(np.asarray(yh), np.asarray(yl))


# ---------------------------------------------------------------------------
# public entry
# ---------------------------------------------------------------------------

def spmv_plan(plan, x: Array, *, semiring: str = "plus_times") -> Array:
    """Run SpMV ``y = A (+).(x) x`` from a prebuilt plan over a semiring.

    Dispatches on plan type: :class:`~..formats.dia.DiaPlan` runs the
    gather-free diagonal executor, :class:`~..formats.dia.HybridPlan` adds
    the SELL residual pass, :class:`SellPlan` runs the fused
    gather-reduce executor; cached, chunk and COO plans compose these.

    ``semiring``: name or :class:`.semiring.Semiring` — plus_times,
    min_plus, max_plus, max_times, or_and ({0,1}-float encoded).  The plan
    must have been built with ``pad_value`` = the semiring's zero
    (``auto_plan(semiring=...)`` does this); DIA plans support plus_times
    only.
    """
    from ..formats.cached import CachedPlan, CooTail
    from ..formats.chunk import ChunkPlan
    from ..formats.dia import DiaPlan, HybridPlan
    from . import semiring as sr
    from .spmv_dia import spmv_dia, spmv_dia_double

    platform.route()
    semiring = sr.get(semiring).name
    if isinstance(plan, ChunkPlan):
        return _spmv_chunk(plan, jnp.asarray(x), semiring=semiring)
    if isinstance(plan, CooTail):
        # tiny residues: one element gather + segment reduce
        s = sr.get(semiring)
        mul, _ = sr.kernel_ops(semiring)
        xd = jnp.asarray(x)
        prod = mul(plan.vals.astype(xd.dtype),
                   jnp.take(xd, plan.cols, axis=0, mode="clip"))
        rows = plan.shape[0]
        y = s.segment_reduce(prod, plan.rows_idx, num_segments=rows + 1)
        return y[:rows]
    if isinstance(plan, CachedPlan):
        # hot part on the compact remapped domain, cold tail on the
        # original domain; each nonzero lives in exactly one part, so the
        # merge is one semiring add — the two-pipe join of
        # SpMVFrontendBufferSel.scala:125-145
        s = sr.get(semiring)
        xd = jnp.asarray(x)
        y = spmv_plan(plan.hot, jnp.take(xd, jnp.asarray(plan.hot_cols)),
                      semiring=semiring)
        if plan.cold is not None:
            yc = spmv_plan(plan.cold, xd, semiring=semiring)
            # or_and's logical add yields bool; restore the float encoding
            y = s.add(y, yc).astype(yc.dtype)
        return y
    if isinstance(plan, (DiaPlan, HybridPlan)) and semiring != "plus_times":
        raise ValueError("DIA plans encode absence as 0 and support only "
                         "plus_times; build a SELL plan via "
                         "auto_plan(semiring=...)")
    if isinstance(plan, DiaPlan):
        if plan.double:
            return spmv_dia_double(plan, x)
        return spmv_dia(plan, x)
    if isinstance(plan, HybridPlan):
        if plan.dia.double:
            return spmv_dia_double(plan.dia, x) + spmv_plan(plan.rest, x)
        return spmv_dia(plan.dia, x) + spmv_plan(plan.rest, x)
    if plan.stats.double:
        if semiring != "plus_times":
            raise ValueError(
                f"double-float plans run plus_times only (error-free "
                f"transformations are +/* identities); got {semiring!r}")
        return spmv_sell_double(plan, x)
    return _spmv_sell(plan, jnp.asarray(x), semiring=semiring)
