"""Multi-device SpMV/SpMM: row-partitioned plans under shard_map.

The reference is a single-chip accelerator — its only "scaling" mechanism
is swapping bitfiles (``devcfg.cpp``); SURVEY.md §2.4 calls out multi-chip
scaling as the capability this build adds.  Design per the scaling-book
recipe: pick a mesh, shard the data, let collectives move the dense
vector, overlap with per-shard compute.

* The matrix is partitioned into ``D`` contiguous **row blocks**, one per
  device along mesh axis ``"x"``; each block gets its own SELL plan, and
  the plans are stacked into uniform (D, T, P, R) arrays (padded to the
  largest shard) so the same program runs on every device — SPMD, no
  per-device shapes.
* **x exchange**: the dense vector is row-sharded like y; before the local
  SpMV each device assembles the x segments it needs:
  - ``all_gather`` mode (general matrices): x all-gathered over the device
    links — the bandwidth-robust default;
  - ``halo`` mode (banded matrices): each device fetches only neighbor
    halos via ``ppermute`` — the ``maxColSpan``/bandwidth analysis
    (``SparseMatrix.cpp:110-119``) decides eligibility, exactly as it
    guided buffer sizing in the reference.
* Per-shard compute is the **same single-device SELL executor** over the
  shard's tiles.  Results concatenate along the row axis with no
  cross-device reduction, because rows are uniquely owned.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..formats import analysis
from ..formats.containers import CSR
from ..formats.plan import (WINDOW_GROUP_TILES, _as_csr, build_sell_plan,
                            compute_cols_win)
from ..utils import platform

Array = Any


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class ShardedPlan:
    """D row-block SELL plans stacked for SPMD execution.

    All shards share tile count T (zero-padded), so arrays are
    (D, T, P, R); ``rows_per_shard`` is the uniform row-block height
    (multiple of 128; last block zero-padded).  ``halo`` is the column
    halo width each side (multiple of 128) for the banded exchange mode
    (0 = not banded / use all-gather).
    """

    vals: Array          # (D, T, P, R)
    cols: Array          # (D, T, P, R) — GLOBAL column indices
    cols_win: Array      # (D, T, P, R) int16 in-window offsets (empty K == 0)
    tile_slice: Array    # (D, T)
    window_base: Array   # (D, T/WINDOW_GROUP_TILES) — global x window base
    row_map: Array       # (D, num_slices*R) — LOCAL row ids (rps = padding)
    shape: Tuple[int, int]
    num_shards: int
    rows_per_shard: int
    identity_map: bool
    halo: int
    window_blocks: int   # merged K (0 = some shard's span is over the cap)
    max_window_base: int
    groups_per_step: int

    _array_fields = ("vals", "cols", "cols_win", "tile_slice", "window_base",
                     "row_map")

    def tree_flatten(self):
        children = tuple(getattr(self, f) for f in self._array_fields)
        aux = (self.shape, self.num_shards, self.rows_per_shard,
               self.identity_map, self.halo, self.window_blocks,
               self.max_window_base, self.groups_per_step)
        return children, aux

    @classmethod
    def tree_unflatten(cls, aux, children):
        (shape, num_shards, rows_per_shard, identity_map, halo,
         window_blocks, max_window_base, groups_per_step) = aux
        vals, cols, cols_win, tile_slice, window_base, row_map = children
        return cls(vals=vals, cols=cols, cols_win=cols_win,
                   tile_slice=tile_slice,
                   window_base=window_base, row_map=row_map, shape=shape,
                   num_shards=num_shards, rows_per_shard=rows_per_shard,
                   identity_map=identity_map, halo=halo,
                   window_blocks=window_blocks,
                   max_window_base=max_window_base,
                   groups_per_step=groups_per_step)

    @property
    def num_slices(self) -> int:
        return int(self.row_map.shape[1]) // 128


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def build_sharded_plan(a, num_shards: int, *, value_dtype=np.float32,
                       sigma: Optional[int] = None,
                       split: Optional[int] = None,
                       max_window_blocks: int = 16) -> ShardedPlan:
    """Partition rows into ``num_shards`` blocks and plan each (host-side)."""
    csr = _as_csr(a)
    rows, cols_n = csr.shape
    rps = _round_up(_round_up(rows, num_shards) // num_shards, 128)
    indptr = np.asarray(csr.indptr, dtype=np.int64)
    indices = np.asarray(csr.indices)
    data = np.asarray(csr.data)

    plans = []
    for d in range(num_shards):
        r0, r1 = min(d * rps, rows), min((d + 1) * rps, rows)
        e0, e1 = indptr[r0], indptr[r1]
        local_indptr = np.concatenate([
            (indptr[r0:r1 + 1] - e0) if r1 > r0 else np.zeros(1, np.int64),
            np.full(rps - (r1 - r0), e1 - e0, np.int64)]).astype(np.int32)
        sub = CSR(data=data[e0:e1], indices=indices[e0:e1],
                  indptr=local_indptr, shape=(rps, cols_n))
        # grain fixed at 128 so cols_win stays valid under the halo
        # mode's shift by whole 128-column blocks (note below)
        plans.append(build_sell_plan(
            sub, value_dtype=value_dtype, sigma=sigma, split=split,
            max_window_blocks=max_window_blocks, window_grain=128))

    wb_feasible_pre = all(p.stats.window_blocks > 0 for p in plans)
    groups = 1
    T = _round_up(max(p.num_tiles for p in plans), 8 * groups)
    S = max(p.num_slices for p in plans)
    D = num_shards
    Pp, R = plans[0].positions, plans[0].lane_rows
    vals = np.zeros((D, T, Pp, R), dtype=value_dtype)
    cols = np.zeros((D, T, Pp, R), dtype=np.int32)
    tile_slice = np.zeros((D, T), dtype=np.int32)
    window_base = np.zeros((D, T // WINDOW_GROUP_TILES), dtype=np.int32)
    row_map = np.full((D, S * R), rps, dtype=np.int32)
    for d, p in enumerate(plans):
        t = p.num_tiles
        vals[d, :t] = p.vals
        cols[d, :t] = p.cols
        tile_slice[d, :t] = p.tile_slice
        tile_slice[d, t:] = S - 1          # padding tiles: last slice, zeros
        window_base[d, :t // WINDOW_GROUP_TILES] = p.window_base
        row_map[d, :p.row_map.shape[0]] = p.row_map

    identity = all(p.identity_map for p in plans) and \
        all(p.num_slices == S for p in plans)
    wb_feasible = wb_feasible_pre
    window_blocks = max(p.stats.window_blocks for p in plans) \
        if wb_feasible else 0
    max_window_base = max(p.stats.max_window_base for p in plans)

    # in-window offsets are invariant to the halo shift (cols and
    # window_base shift by the same multiple of 128), so one stacked
    # int16 array serves both exchange modes
    if window_blocks:
        cols_win = np.stack([
            compute_cols_win(vals[d] != 0, cols[d], window_base[d],
                             window_blocks)
            for d in range(D)])
    else:
        cols_win = np.zeros((D, 0, Pp, R), np.int16)

    bw = analysis.bandwidth(csr)
    halo = _round_up(int(bw), 128) if 0 < bw <= rps else 0

    return ShardedPlan(vals=vals, cols=cols, cols_win=cols_win,
                       tile_slice=tile_slice,
                       window_base=window_base, row_map=row_map,
                       shape=(rows, cols_n), num_shards=D,
                       rows_per_shard=rps, identity_map=identity,
                       halo=halo, window_blocks=window_blocks,
                       max_window_base=max_window_base,
                       groups_per_step=groups)


# ---------------------------------------------------------------------------
# per-shard executors
# ---------------------------------------------------------------------------

def _local_spmv(vals, cols, tile_slice, row_map, x_full, *,
                num_slices: int, rows_local: int, identity: bool):
    """One shard's SpMV: the single-device SELL gather-reduce executor
    (``ops.spmv_exec._tile_partials``) over the shard's tiles, then the
    tile -> slice fold and row fixup."""
    from ..ops.spmv_exec import _tile_partials

    partial_t = _tile_partials(vals, cols, x_full, "plus_times")  # (T, R)
    y2d = jax.ops.segment_sum(partial_t, tile_slice, num_segments=num_slices,
                              indices_are_sorted=True)
    flat = y2d.reshape(-1)
    if identity:
        return flat[:rows_local]
    y = jax.ops.segment_sum(flat, row_map, num_segments=rows_local + 1)
    return y[:rows_local]


def spmv_sharded(sp: ShardedPlan, x: Array, mesh: Mesh, *,
                 axis: str = "x", mode: str = "auto") -> Array:
    """Distributed ``y = A @ x`` with x and y row-sharded over ``axis``.

    ``mode``: 'all_gather' | 'halo' | 'auto' (halo when the plan's
    bandwidth permits).  Returns y (unsharded host view; sharded under
    jit).
    """
    platform.route()
    if mode == "auto":
        mode = "halo" if 0 < sp.halo <= sp.rows_per_shard else "all_gather"
    D, rps = sp.num_shards, sp.rows_per_shard
    rows = sp.shape[0]
    num_slices = sp.num_slices
    identity = sp.identity_map
    halo = sp.halo

    if sp.shape[1] > D * rps:
        raise ValueError(
            f"cols ({sp.shape[1]}) exceed the sharded x capacity "
            f"({D} shards x {rps}); row-partitioning assumes cols <= rows "
            "padded — transpose or pad the matrix")
    xp = jnp.zeros(D * rps, sp.vals.dtype).at[:sp.shape[1]].set(
        jnp.asarray(x, sp.vals.dtype))

    def local_fn(vals, cols, tile_slice, row_map, x_shard):
        vals, cols = vals[0], cols[0]
        tile_slice, row_map = tile_slice[0], row_map[0]
        x_shard = x_shard.reshape(-1)                     # (rps,)
        if mode == "all_gather":
            x_full = jax.lax.all_gather(x_shard, axis).reshape(-1)
            cols_local = cols
        else:
            d = jax.lax.axis_index(axis)
            left = jax.lax.ppermute(x_shard[-halo:], axis,
                                    [(i, (i + 1) % D) for i in range(D)])
            right = jax.lax.ppermute(x_shard[:halo], axis,
                                     [(i, (i - 1) % D) for i in range(D)])
            x_full = jnp.concatenate([left, x_shard, right])
            shift = d * rps - halo
            # the clip only moves padding slots (value 0) of edge shards
            cols_local = jnp.clip(cols - shift, 0, x_full.shape[0] - 1)
        y_local = _local_spmv(
            vals, cols_local, tile_slice, row_map, x_full,
            num_slices=num_slices, rows_local=rps, identity=identity)
        return y_local[None, :]

    fn = jax.shard_map(
        local_fn, mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis), P(axis)),
        out_specs=P(axis))
    y = fn(sp.vals, sp.cols, sp.tile_slice, sp.row_map, xp.reshape(D, rps))
    return y.reshape(-1)[:rows]


def spmm_sharded(sp: ShardedPlan, b: Array, mesh: Mesh, *,
                 axis: str = "x") -> Array:
    """Distributed ``Y = A @ B`` (B replicated, Y row-sharded): each
    shard runs the single-device SELL SpMM executor
    (``ops.spmm_exec.sell_spmm_partials``), which reads the nonzero
    stream once for all k right-hand sides."""
    from ..ops.spmm_exec import sell_spmm_partials

    platform.route()
    D, rps = sp.num_shards, sp.rows_per_shard
    rows = sp.shape[0]
    num_slices = sp.num_slices
    identity = sp.identity_map
    k = b.shape[1]

    def local_fn(vals, cols, tile_slice, row_map, b_full):
        vals, cols = vals[0], cols[0]
        tile_slice, row_map = tile_slice[0], row_map[0]
        contrib = sell_spmm_partials(vals, cols, b_full)   # (T, R, k)
        y3d = jax.ops.segment_sum(contrib, tile_slice,
                                  num_segments=num_slices,
                                  indices_are_sorted=True)  # (S, R, k)
        flat = y3d.reshape(-1, k)
        if identity:
            return flat[None, :rps]
        y = jax.ops.segment_sum(flat, row_map, num_segments=rps + 1)
        return y[None, :rps]

    bp = jnp.zeros((D * rps, k), sp.vals.dtype)
    bp = bp.at[:sp.shape[1]].set(jnp.asarray(b, sp.vals.dtype))
    fn = jax.shard_map(
        local_fn, mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis), P()),
        out_specs=P(axis))
    y = fn(sp.vals, sp.cols, sp.tile_slice, sp.row_map, bp)
    return y.reshape(-1, k)[:rows]


def make_mesh(n_devices: Optional[int] = None, axis: str = "x") -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.array(devs[:n]), (axis,))
