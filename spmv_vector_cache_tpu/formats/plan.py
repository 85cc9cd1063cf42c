"""SpMV execution plans: the layout step that replaces hazard hardware.

The reference streams CSC and pays for the scattered update
``y[rowInd] += v`` with interlock hardware — shadow queues, CAM issue
windows, and a vector cache in front of y (``chisel/frontend/``,
``chisel/cache-new/``, SURVEY.md §2.1).  Here the irregularity is removed
by *layout*, not tracked at runtime.  This module builds a
**sliced-ELLPACK (SELL-C-sigma) tile plan** over CSR:

* rows are bound to *lanes* — 128 consecutive (sub)rows form a *slice*,
  and a slice's nonzeros are stored as (P, 128) value/column tiles whose
  first axis holds successive nonzero positions of each row.  The row
  reduction is a sum over that axis, so the scatter disappears (the
  RAW-hazard interlocks of ``InterleavedReduce.scala:51-57`` and
  ``SpMVFrontendNBCache.scala:26-77`` have nothing left to guard);
* long rows *split* into bounded sub-rows (the load-balance fix the
  reference probes with its ``row64k`` matrix and
  ``permuteLongestRowFirst``, ``matrixutils.py:148-158``);
* sub-rows may be length-sorted within ``sigma`` windows (SELL-sigma) so
  slices hold similar-length rows and padding stays small;
* optionally, rows split at **column-stripe** boundaries so every tile's
  column span is bounded; the merge back to y is one segment-sum (the
  same fixup that serves split/sigma).

The irregular access that remains is the *gather* of x[col] — the exact
dual of the reference's y problem (CSC makes x sequential and y scattered;
CSR makes y sequential and x gathered).  The plan also records, per group
of tiles, a **window base** ``wb`` such that every column the group
touches lies in ``[wb*grain, wb*grain + K*128)``; K (``window_blocks``)
measures the layout's column locality — the port of the reference's
``maxColSpan`` analysis (``SparseMatrix.cpp:110-119``) deciding buffer
strategy — and the planner routes on it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import jax
import numpy as np

from .containers import COO, CSC, CSR
from .convert import coo_to_csr, csc_to_csr

Array = Any

#: tile-count granularity: every plan holds a multiple of 8 tiles
TILES_PER_STEP = 8

#: default tiles sharing one x-window base (overridable per plan via
#: ``window_group_tiles``).  Finer granularity shrinks each window's
#: column span; must divide TILES_PER_STEP.
WINDOW_GROUP_TILES = 4


@dataclasses.dataclass(frozen=True)
class PlanStats:
    """Layout-quality counters — the plan-time half of the observability
    story (the runtime half lives in ``utils/stats.py``)."""

    nnz: int
    num_tiles: int          # padded to TILES_PER_STEP
    num_slices: int
    num_subrows: int
    num_splits: int
    num_stripes: int        # column stripes (1 = no striping)
    padded_slots: int
    fill: float             # nnz / (num_tiles * P * R)
    window_blocks: int      # K: column blocks a tile group spans (0 = over cap)
    max_window_base: int    # max of window_base
    groups_per_step: int    # tile count is padded to a multiple of 8x this
    pad_value: float = 0.0  # value of padding slots (the semiring's zero)
    uniform_tiles_per_slice: int = 0  # u if every slice spans exactly u
    # tiles and u | 8; 0 otherwise
    group_tiles: int = WINDOW_GROUP_TILES  # tiles per x-window group (wg)
    #: p when every row has exactly p sub-rows in natural (row-major)
    #: order — the epilogue then folds y with one reshape+reduce instead
    #: of a scattered segment sum; 0 otherwise
    uniform_parts: int = 0
    #: all tiles of each wg-group share one slice
    group_fold: bool = False
    #: group g *is* slice g for g < num_slices (uniform tiling): the
    #: tile -> slice fold is a reshape, no segment-sum at all
    group_slice_identity: bool = False
    #: double-float layout: vals is f32 (T, 2*positions, R) with value
    #: highs in [:, :P] and lows in [:, P:] — the f64-parity datapath
    #: (cf. the reference's DP cores, ``SemiringOp.scala:98-154``)
    double: bool = False
    #: lane granularity of ``window_base`` (128, 64, or 32).  Finer grain
    #: lets a window start mid-block, shaving a whole 128-lane block off
    #: K when group spans straddle block boundaries (a span of 90 needs
    #: K=2 at grain 128 but K=1 at grain 32); the xw prologue gathers
    #: from a (128/grain)-way overlapped x image to pay for it
    window_grain: int = 128

    def as_dict(self):
        return dataclasses.asdict(self)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class SellPlan:
    """Tiled SELL layout of one sparse matrix, ready for the executors.

    ``vals``/``cols``: (T, P, R) — tile t covers R=128 sub-rows (lane axis)
    of slice ``tile_slice[t]`` and P=8 successive nonzero positions of each
    (sublane axis); padding slots carry (0, column 0).  ``tile_slice`` is
    nondecreasing.  ``window_base``: (T/WINDOW_GROUP_TILES,) per-group x
    window base in 128-lane blocks (only meaningful when
    ``stats.window_blocks > 0``).
    ``row_map`` sends sub-row slots back to original rows for the
    split/sigma/stripe fixup; ``identity_map`` means y is simply the first
    ``rows`` entries of the flat sub-row vector.
    """

    vals: Array          # (T, P, R) value dtype
    cols: Array          # (T, P, R) int32 global column ids
    cols_win: Array      # (T, P, R) int16 in-window offsets (empty if K == 0)
    tile_slice: Array    # (T,) int32, nondecreasing
    window_base: Array   # (T/group_tiles,) int32 x window base
    row_map: Array       # (num_slices * R,) int32 → original row, `rows` = pad
    #: (T/group_tiles * K,) int32 row ids of each group's x window in the
    #: 128-wide x image (``compute_window_rows``); empty when K == 0
    window_rows: Array
    shape: Tuple[int, int]
    lane_rows: int       # R
    positions: int       # P
    identity_map: bool
    stats: PlanStats

    _array_fields = ("vals", "cols", "cols_win", "tile_slice", "window_base",
                     "row_map", "window_rows")

    def tree_flatten(self):
        children = tuple(getattr(self, f) for f in self._array_fields)
        aux = (self.shape, self.lane_rows, self.positions, self.identity_map,
               self.stats)
        return children, aux

    @classmethod
    def tree_unflatten(cls, aux, children):
        shape, lane_rows, positions, identity_map, stats = aux
        (vals, cols, cols_win, tile_slice, window_base, row_map,
         window_rows) = children
        return cls(vals=vals, cols=cols, cols_win=cols_win,
                   tile_slice=tile_slice,
                   window_base=window_base, row_map=row_map,
                   window_rows=window_rows, shape=shape,
                   lane_rows=lane_rows, positions=positions,
                   identity_map=identity_map, stats=stats)

    @property
    def num_tiles(self) -> int:
        return int(self.vals.shape[0])

    @property
    def num_slices(self) -> int:
        return int(self.row_map.shape[0]) // self.lane_rows

    def to_device(self):
        leaves, aux = self.tree_flatten()
        return type(self).tree_unflatten(
            aux, tuple(jax.numpy.asarray(l) for l in leaves))


def _as_csr(a) -> CSR:
    if isinstance(a, CSC):
        a = csc_to_csr(a)
    elif isinstance(a, COO):
        a = coo_to_csr(a)
    elif not isinstance(a, CSR):
        raise TypeError(f"cannot plan over {type(a)}")
    return _ensure_sorted(a)


def _ensure_sorted(a: CSR) -> CSR:
    """Planning (striping, window spans, DIA detection) assumes
    column-sorted rows; sort lazily when a hand-built CSR is not."""
    indices = np.asarray(a.indices)
    if indices.size < 2:
        return a
    indptr = np.asarray(a.indptr, dtype=np.int64)
    decreasing = np.flatnonzero(np.diff(indices.astype(np.int64)) < 0) + 1
    if decreasing.size == 0 or np.all(np.isin(decreasing, indptr)):
        return a
    rows = np.repeat(np.arange(a.shape[0], dtype=np.int64),
                     np.diff(indptr))
    order = np.lexsort((indices, rows))
    return CSR(data=np.asarray(a.data)[order], indices=indices[order],
               indptr=a.indptr, shape=a.shape)


def _cdiv(a, b):
    return -(-a // b)


def compute_cols_win(live: np.ndarray, cols: np.ndarray,
                     window_base: np.ndarray, window_blocks: int,
                     group_tiles: int = WINDOW_GROUP_TILES,
                     window_grain: int = 128) -> np.ndarray:
    """In-window column offsets: the int16 index form of a windowed layout.

    Live slots (``live`` mask; ``vals != 0`` for plus-times plans) become
    ``col - window_base[group]*128`` — by construction in
    ``[0, window_blocks*128)``, so they fit int16, half the index bytes of
    the global int32 ``cols`` (cf. the reference's per-channel burst
    sizing, ``spmv-common.scala:26-29``).  Padding slots are forced to
    offset 0.  Returns an empty (0, P, R) array when the layout has no
    bounded window (``window_blocks == 0``).  The executors in ``ops/``
    read the global ``cols``; this form is kept for a windowed kernel.
    """
    T, P, R = cols.shape
    if not window_blocks or not T:
        return np.zeros((0, P, R), np.int16)
    wb_tile = np.repeat(np.asarray(window_base, np.int64), group_tiles)
    off = cols.astype(np.int64) - (wb_tile * window_grain)[:, None, None]
    off = np.where(live != 0, off, 0)
    return off.astype(np.int16)


def window_image_blocks(num_cols: int, max_window_base: int,
                        window_blocks: int, window_grain: int = 128) -> int:
    """Rows (in 128-lane blocks) of the canonical x image a windowed
    layout's groups index (see ``compute_window_rows``)."""
    return max(_cdiv(num_cols, 128),
               _cdiv(max_window_base * window_grain +
                     window_blocks * 128, 128)) + 1


def compute_window_rows(window_base: np.ndarray, window_blocks: int,
                        num_cols: int,
                        window_grain: int = 128) -> np.ndarray:
    """x-image row ids of every group's window (see SellPlan.window_rows).
    At grain g < 128 the image is (128/g)-way overlapped — its row j
    covers elements [g*j, g*j + 128) — and a window's k-th block is row
    ``wb + (128/g)*k``."""
    if not window_blocks:
        return np.zeros((0,), np.int32)
    wb = np.asarray(window_base, np.int64)
    f = 128 // window_grain
    nb = window_image_blocks(num_cols, int(wb.max(initial=0)),
                             window_blocks, window_grain)
    wr = wb[:, None] + f * np.arange(window_blocks, dtype=np.int64)[None, :]
    return np.clip(wr, 0, f * nb - 1).astype(np.int32).reshape(-1)


def build_sell_plan(a, *, lane_rows: int = 128, positions: int = 8,
                    sigma: Optional[int] = None,
                    split: Optional[int] = None,
                    stripe_width: Optional[int] = None,
                    max_window_blocks: int = 16,
                    groups_per_step: Optional[int] = None,
                    value_dtype=np.float32,
                    pad_value: float = 0.0,
                    window_group_tiles: Optional[int] = None,
                    uniform_split: bool = False,
                    window_grain: Optional[int] = None) -> SellPlan:
    """Build a SELL tile plan from any container (host-side, numpy).

    ``split``: max nonzeros per sub-row (None = no splitting).
    ``sigma``: window (in sub-rows) for descending length sort.
    ``stripe_width``: split rows at column boundaries of this width so
    every tile group's column span stays bounded (None = off).
    ``max_window_blocks``: cap on K; if a layout needs more, the plan is
    marked window-infeasible (``stats.window_blocks == 0``).
    ``groups_per_step``: pad the tile count to a multiple of
    ``8 * groups_per_step`` (rounded up to a multiple of the window group
    size) — alignment for callers that stack plans; None = 1.
    ``pad_value``: value of padding slots — the additive identity of the
    semiring the plan will run under (0 for plus-times, +inf for
    min-plus, ...), so padding contributes nothing to any reduction.
    ``window_group_tiles``: tiles sharing one x-window base (must divide
    TILES_PER_STEP); smaller groups shrink the per-window column span.
    ``window_grain``: lane granularity of window bases (None = pick the
    coarsest of 128/64/32 that minimizes K).
    ``uniform_split``: with ``split``, give EVERY row exactly
    ``ceil(max_len/split)`` sub-rows (empty ones padded) and pad every
    slice to the same tile count — a 128-lane slice then covers a fixed
    block of ``128/parts`` rows (shrinking the window span) and the y
    fixup collapses to one lane fold (``stats.uniform_parts``); with
    ``window_group_tiles == ceil(split/positions)`` each window group is
    exactly one slice and the tile -> slice fold is a reshape
    (``stats.group_slice_identity``).
    """
    csr = _as_csr(a)
    wg = window_group_tiles if window_group_tiles is not None \
        else WINDOW_GROUP_TILES
    if TILES_PER_STEP % wg:
        raise ValueError(f"window_group_tiles ({wg}) must divide "
                         f"TILES_PER_STEP ({TILES_PER_STEP})")
    if uniform_split and (split is None or stripe_width is not None):
        raise ValueError("uniform_split requires split= and no striping")
    double = np.dtype(value_dtype) == np.float64
    if double and pad_value != 0.0:
        raise ValueError("double-float plans support plus_times only "
                         "(pad_value must be 0)")
    if double and positions & (positions - 1):
        raise ValueError(
            f"double-float plans need a power-of-two positions (got "
            f"{positions}): the compensated pairwise reduction halves the "
            f"sublane axis and would silently drop columns otherwise")
    rows, cols_n = csr.shape
    indptr = np.asarray(csr.indptr, dtype=np.int64)
    indices = (np.asarray(csr.indices, dtype=np.int64) & 0x3FFFFFFF)
    data = np.asarray(csr.data)
    nnz = int(indptr[-1])
    R, P, B = lane_rows, positions, TILES_PER_STEP

    # --- 1. sub-row pieces: (row [, stripe]) [, split] ---------------------
    nz_row = np.repeat(np.arange(rows, dtype=np.int64),
                       np.diff(indptr)) if nnz else np.zeros(0, np.int64)
    if stripe_width is not None and nnz:
        nz_stripe = indices // stripe_width
        # piece boundary where row or stripe changes (cols sorted per row)
        key_change = np.ones(nnz, dtype=bool)
        key_change[1:] = (nz_row[1:] != nz_row[:-1]) | \
                         (nz_stripe[1:] != nz_stripe[:-1])
        piece_id = np.cumsum(key_change) - 1
        num_pieces = int(piece_id[-1]) + 1
        piece_start = np.flatnonzero(key_change).astype(np.int64)
        piece_len = np.diff(np.concatenate([piece_start, [nnz]]))
        piece_row = nz_row[piece_start]
        piece_stripe = nz_stripe[piece_start]
        num_stripes = int(nz_stripe.max()) + 1 if nnz else 1
    else:
        piece_start = indptr[:-1].copy()
        piece_len = np.diff(indptr)
        piece_row = np.arange(rows, dtype=np.int64)
        piece_stripe = np.zeros(rows, dtype=np.int64)
        num_stripes = 1

    uniform_parts = 0
    if split is not None and piece_len.size and \
            (piece_len.max() > split or uniform_split):
        if uniform_split:
            # every row gets exactly p sub-rows (trailing ones possibly
            # empty): slices then tile a fixed rows-per-slice block and
            # the y fixup is one reshape+reduce (see stats.uniform_parts)
            p_parts = max(1, int(_cdiv(int(piece_len.max()), split)))
            if p_parts > R:
                # part-major lane placement needs rows_per_slice = R // p
                # >= 1; more parts than lanes cannot be laid out
                raise ValueError(
                    f"uniform_split: max row length {int(piece_len.max())} "
                    f"needs {p_parts} sub-rows of {split} nnz, more than "
                    f"lane_rows={R}; raise split or use plain split=")
            pieces = np.full(piece_row.shape[0], p_parts, dtype=np.int64)
        else:
            pieces = np.maximum(1, _cdiv(piece_len, split))
        rep = np.repeat(np.arange(piece_row.shape[0], dtype=np.int64), pieces)
        within = np.arange(rep.shape[0], dtype=np.int64) - \
            np.repeat(np.cumsum(pieces) - pieces, pieces)
        sub_start = np.minimum(piece_start[rep] + within * split,
                               piece_start[rep] + piece_len[rep])
        sub_len = np.clip(piece_len[rep] - within * split, 0, split)
        sub_row = piece_row[rep]
        sub_stripe = piece_stripe[rep]
        num_splits = int((pieces > 1).sum())
        if uniform_split and p_parts > 1 and sigma is None:
            uniform_parts = p_parts
    else:
        sub_start, sub_len = piece_start, piece_len
        sub_row, sub_stripe = piece_row, piece_stripe
        num_splits = 0
    num_subrows = int(sub_row.shape[0])

    # --- 2. ordering: stripe-major, then sigma length sort ------------------
    sorted_applied = False
    if num_subrows:
        if sigma is not None and num_subrows > 1:
            # order by (stripe asc, length desc) within sigma windows of the
            # stripe-sorted sequence
            stripe_order = np.argsort(sub_stripe, kind="stable")
            order = stripe_order.copy()
            lens_s = sub_len[stripe_order]
            stripes_s = sub_stripe[stripe_order]
            max_len = int(sub_len.max()) if sub_len.size else 0
            for w0 in range(0, num_subrows, sigma):
                w1 = min(w0 + sigma, num_subrows)
                # keep stripes contiguous: sort key = (stripe asc, len desc)
                key = stripes_s[w0:w1].astype(np.int64) * (max_len + 1) \
                    - lens_s[w0:w1]
                seg = np.argsort(key, kind="stable")
                order[w0:w1] = stripe_order[w0:w1][seg]
            sorted_applied = True
        elif num_stripes > 1:
            order = np.argsort(sub_stripe, kind="stable")
            sorted_applied = bool((order != np.arange(num_subrows)).any())
        else:
            order = np.arange(num_subrows, dtype=np.int64)
    else:
        order = np.zeros(0, dtype=np.int64)

    o_len = sub_len[order]
    o_start = sub_start[order]
    o_row = sub_row[order]
    o_stripe = sub_stripe[order]

    # pad sub-row sequence so slices are stripe-pure (stripe changes only at
    # slice boundaries)
    if num_stripes > 1 and num_subrows:
        keep_parts = []
        for s in range(num_stripes):
            idx = np.flatnonzero(o_stripe == s)
            if idx.size == 0:
                continue
            keep_parts.append(idx)
            pad = (-idx.size) % R
            if pad:
                keep_parts.append(np.full(pad, -1, dtype=np.int64))
        slot_src = np.concatenate(keep_parts)
    elif uniform_parts and num_subrows:
        # part-major within each slice: a slice covers rows_per_slice =
        # R // p consecutive rows, with part j of row r at lane
        # j*rows_per_slice + (r % rows_per_slice).  The y fixup is then a
        # contiguous-lane fold of y2d
        p_u = uniform_parts
        rps_u = R // p_u
        n_slices_u = _cdiv(rows, rps_u)
        slot_src = np.full(n_slices_u * R, -1, dtype=np.int64)
        k = np.arange(num_subrows, dtype=np.int64)
        k_row = k // p_u
        dest = (k_row // rps_u) * R + (k % p_u) * rps_u + (k_row % rps_u)
        slot_src[dest] = k
    else:
        slot_src = np.arange(num_subrows, dtype=np.int64)

    num_slots = slot_src.shape[0]
    num_slices = max(1, _cdiv(num_slots, R))
    padded_slots_rows = num_slices * R

    slot_len = np.zeros(padded_slots_rows, dtype=np.int64)
    slot_valid = np.zeros(padded_slots_rows, dtype=bool)
    slot_valid[:num_slots] = slot_src >= 0
    slot_len[:num_slots][slot_src >= 0] = o_len[slot_src[slot_src >= 0]]

    # --- 3. slices and tile allocation -------------------------------------
    slice_len = slot_len.reshape(num_slices, R).max(axis=1)
    ntiles = np.maximum(1, _cdiv(slice_len, P))
    if uniform_parts:
        # uniform tiling: every slice gets the same ceil(split/P) tiles so
        # window groups align 1:1 with slices (group_slice_identity)
        ntiles = np.full(num_slices, max(1, _cdiv(split, P)), np.int64)

    # stripe of each slice (slices are stripe-pure by construction; empty
    # slices inherit the previous stripe so contiguity is preserved)
    slice_stripe = np.zeros(num_slices, dtype=np.int64)
    if num_stripes > 1 and num_slots:
        slot_stripe = np.full(padded_slots_rows, -1, dtype=np.int64)
        slot_stripe[:num_slots][slot_src >= 0] = \
            o_stripe[slot_src[slot_src >= 0]]
        for s in range(num_slices):
            seg = slot_stripe[s * R:(s + 1) * R]
            valid = seg[seg >= 0]
            slice_stripe[s] = valid[0] if valid.size else \
                (slice_stripe[s - 1] if s else 0)

    # pad each stripe's tile count to a multiple of B so no group of B
    # tiles straddles stripes; pad tiles attach to the stripe's last
    # slice and hold only zeros
    ntiles_padded = ntiles.copy()
    if num_stripes > 1:
        for stripe_val in np.unique(slice_stripe):
            sel = np.flatnonzero(slice_stripe == stripe_val)
            total = int(ntiles_padded[sel].sum())
            pad = (-total) % B
            if pad:
                ntiles_padded[sel[-1]] += pad
    elif not uniform_parts:
        # (uniform layouts keep every slice at exactly its tile count so
        # the tile -> slice fold stays a reshape; the tail padding below
        # adds whole empty groups instead)
        total = int(ntiles_padded.sum())
        pad = (-total) % B
        if pad:
            ntiles_padded[-1] += pad
    tile_base = np.concatenate(([0], np.cumsum(ntiles_padded)))
    T = int(tile_base[-1])

    vals = np.full((T, P, R), pad_value, dtype=value_dtype)
    cols = np.zeros((T, P, R), dtype=np.int32)
    live = np.zeros((T, P, R), dtype=bool)
    if nnz:
        vsrc = slot_src[slot_src >= 0]
        k_slot = np.flatnonzero(slot_valid)          # slot index per subrow
        lens = o_len[vsrc]
        k = np.repeat(k_slot, lens)
        q = np.arange(k.shape[0], dtype=np.int64) - \
            np.repeat(np.cumsum(lens) - lens, lens)
        src = np.repeat(o_start[vsrc], lens) + q
        s = k // R
        j = k % R
        t = tile_base[s] + q // P
        p = q % P
        vals[t, p, j] = data[src].astype(value_dtype)
        cols[t, p, j] = indices[src].astype(np.int32)
        live[t, p, j] = True

    tile_slice = np.repeat(np.arange(num_slices, dtype=np.int32),
                           ntiles_padded)

    # --- 4. per-group window base + feasibility ------------------------------
    WG = wg
    flat_cols = cols.reshape(T // WG, -1)
    flat_valid = live.reshape(T // WG, -1)
    cmin = np.where(flat_valid, flat_cols, np.iinfo(np.int32).max).min(axis=1)
    cmax = np.where(flat_valid, flat_cols, -1).max(axis=1)
    any_valid = cmax >= 0
    # evaluate window-base granularities finest-first and keep the
    # COARSEST grain achieving the minimal K: a span of 90 straddling a
    # block boundary needs K=2 at grain 128 but K=1 at grain <= 32
    grains = (128,) if not T else (
        (window_grain,) if window_grain else (32, 64, 128))
    best = None                            # (K, -grain, grain, wb)
    for g in grains:
        wbg = np.where(any_valid, cmin, 0) // g
        span = np.where(any_valid,
                        (cmax - wbg * g) // 128 + 1, 1)
        kg = int(span.max()) if T else 1
        cand = (kg, -g, g, wbg)
        if best is None or cand[:2] < best[:2]:
            best = cand
    window_blocks, _, grain, wb = best
    if window_blocks > max_window_blocks:
        window_blocks = 0                  # span over the cap
        grain = 128
        wb = np.where(any_valid, cmin, 0) // 128
    max_window_base = int(wb.max()) if T else 0

    # tile-count padding: every padded tile is streamed on each apply,
    # so pad only as far as a caller asks (a multiple of the window group
    # size keeps groups whole)
    if groups_per_step is not None:
        groups = _cdiv(max(1, groups_per_step), wg) * wg
    else:
        groups = 1
    step = B * groups
    if T % step:
        pad = step - T % step
        vals = np.concatenate([vals,
                               np.full((pad, P, R), pad_value, vals.dtype)])
        cols = np.concatenate([cols, np.zeros((pad, P, R), cols.dtype)])
        live = np.concatenate([live, np.zeros((pad, P, R), bool)])
        tile_slice = np.concatenate(
            [tile_slice, np.full(pad, num_slices - 1, np.int32)])
        wb = np.concatenate([wb, np.zeros(pad // WG, wb.dtype)])
        T = T + pad

    # --- 5. fixup map --------------------------------------------------------
    row_map = np.full(padded_slots_rows, rows, dtype=np.int32)
    vmask = slot_valid[:num_slots]
    row_map[:num_slots][vmask] = o_row[slot_src[:num_slots][vmask]].astype(
        np.int32)
    identity_map = (not sorted_applied) and num_splits == 0 and \
        num_stripes == 1

    # fold structure: does every wg-group of tiles lie in one slice?
    ts_g = tile_slice.reshape(-1, wg)
    group_fold = bool(T) and bool((ts_g == ts_g[:, :1]).all())
    group_slice_identity = group_fold and num_stripes == 1 and \
        bool(np.all(ntiles_padded == wg))

    stats = PlanStats(
        nnz=nnz, num_tiles=T, num_slices=num_slices,
        num_subrows=num_subrows, num_splits=num_splits,
        num_stripes=num_stripes,
        padded_slots=T * P * R - nnz,
        fill=float(nnz) / float(T * P * R) if T else 0.0,
        window_blocks=window_blocks, max_window_base=max_window_base,
        groups_per_step=groups, pad_value=float(pad_value),
        group_tiles=wg, uniform_parts=uniform_parts,
        group_fold=group_fold, group_slice_identity=group_slice_identity,
        double=double, window_grain=grain)

    cols_win = compute_cols_win(live, cols, wb, window_blocks, wg, grain)
    if double:
        # hi/lo f32 channel pairs stacked along the position axis: the
        # device computes in f32 pairs (error-free transformations)
        from ..ops.df64 import split_f64

        hi, lo = split_f64(vals)
        vals = np.concatenate([hi, lo], axis=1)        # (T, 2P, R)
    window_rows = compute_window_rows(wb, window_blocks, cols_n, grain)

    return SellPlan(vals=vals, cols=cols, cols_win=cols_win,
                    tile_slice=tile_slice,
                    window_base=wb.astype(np.int32), row_map=row_map,
                    window_rows=window_rows,
                    shape=(rows, cols_n), lane_rows=R, positions=P,
                    identity_map=identity_map, stats=stats)


#: a diagonal offset set wider than this many columns is not a band: its
#: diagonals are short and scattered, and the SELL layout serves them
DIA_MAX_SPAN = 12 * 64 * 128

#: x of at most this many 128-column blocks is a small working set: every
#: layout's gather stays cache-resident, so neither striping nor a
#: hot/cold column split can improve on the plain layout
NARROW_X_BLOCKS = 64


def auto_plan(a, *, value_dtype=np.float32, max_window_blocks: int = 16,
              lane_rows: int = 128, positions: int = 8,
              allow_dia: bool = True, min_diag_fill: float = 0.5,
              min_dia_coverage: float = 0.3, semiring="plus_times"):
    """Heuristic plan selection driven by structure analyses.

    Decision features are ports of the reference's preprocessing analyses
    (maxAlive / maxColSpan / row-length histogram,
    ``SparseMatrix.cpp:92-119``), extended with diagonal-structure
    detection, and close calls go to the cost model
    (``formats/costmodel.py``).  Returns the best plan *type* for the
    matrix — the role the reference assigns to choosing which accelerator
    bitfile to flash (``HWSpMVFactory.cpp:20-38``):

    0. nonzeros concentrated on dense diagonals -> :class:`~.dia.DiaPlan`
       (gather-free, 4 B/nnz) or a :class:`~.dia.HybridPlan` with the SELL
       residual;
    1. skewed row lengths -> split + sigma sort (or a chunk plan);
    2. plain layout with bounded column spans -> done (banded / narrow);
    3. else the cost model picks among striping, a hot/cold column split,
       the COO path and the plain layout.
    """
    from ..ops import semiring as sr

    s = sr.get(semiring)
    csr = _as_csr(a)
    if s.requires_nonnegative and csr.nnz:
        vmin = np.asarray(csr.data).min()
        if vmin < 0:
            raise ValueError(
                f"semiring {s.name!r} is only a semiring on the "
                f"non-negative domain (its zero={s.zero} must annihilate "
                f"under mul), but the matrix has a negative value "
                f"({vmin}); padding slots would out-reduce true negative "
                f"products.  x must be non-negative too.")
    plus_times = s.name == "plus_times"
    # the DIA container encodes absence as 0, which is only the additive
    # identity of plus-times; other semirings run the SELL path with
    # padding set to their own zero
    if allow_dia and csr.nnz and plus_times:
        plan = _try_dia_plan(csr, value_dtype=value_dtype,
                             max_window_blocks=max_window_blocks,
                             lane_rows=lane_rows, positions=positions,
                             min_diag_fill=min_diag_fill,
                             min_dia_coverage=min_dia_coverage)
        if plan is not None:
            from .dia import HybridPlan

            if isinstance(plan, HybridPlan):
                # diagonal coverage alone must not commit the choice: a
                # HybridPlan whose residual plan collapses can lose to the
                # pure SELL plan it never considered — cost-compare, the
                # HWSpMVFactory role done with a model instead of a
                # signature probe (HWSpMVFactory.cpp:20-38)
                from .costmodel import estimate_seconds

                alt = _auto_sell_plan(
                    csr, value_dtype=value_dtype,
                    max_window_blocks=max_window_blocks,
                    lane_rows=lane_rows, positions=positions,
                    pad_value=float(s.zero), plus_times=plus_times)
                # the model is coarse: veto only decisive losses
                if estimate_seconds(alt) < 0.7 * estimate_seconds(plan):
                    plan = alt
            return plan
    plan = _auto_sell_plan(csr, value_dtype=value_dtype,
                           max_window_blocks=max_window_blocks,
                           lane_rows=lane_rows, positions=positions,
                           pad_value=float(s.zero), plus_times=plus_times)
    if plus_times:
        # tiny-regime backstop: if the structured choice prices out worse
        # than the gather + segment-sum COO path, take the COO path
        plan = _coo_backstop(csr, plan, value_dtype)
    return plan


def _try_dia_plan(csr: CSR, *, value_dtype, max_window_blocks, lane_rows,
                  positions, min_diag_fill, min_dia_coverage):
    """DiaPlan / HybridPlan if the diagonal structure pays for it, else
    None."""
    from .dia import HybridPlan, build_dia_plan, split_diagonal

    dia, rest, coverage = split_diagonal(csr, min_diag_fill=min_diag_fill)
    if dia is None or coverage < min_dia_coverage:
        return None
    offs = np.asarray(dia.offsets)
    if offs.size and int(offs.max() - offs.min()) > DIA_MAX_SPAN:
        return None
    if rest is not None and coverage < 0.98:
        # hybrid only worth a second pass over x/y when the dia part
        # carries real volume
        if dia.nnz < 4 * rest.nnz:
            return None
    dia_plan = build_dia_plan(dia, value_dtype=value_dtype)
    if rest is None:
        return dia_plan
    rest_plan = _auto_sell_plan(rest, value_dtype=value_dtype,
                                max_window_blocks=max_window_blocks,
                                lane_rows=lane_rows, positions=positions)
    rest_plan = _coo_backstop(rest, rest_plan, value_dtype)
    return HybridPlan(dia=dia_plan, rest=rest_plan)


def _coo_backstop(csr: CSR, plan, value_dtype):
    """Prefer the COO path (one gather + one segment sum) when it prices
    below the structured plan (plus-times only; fires mostly on tiny
    layouts with scatter epilogues, like hybrid residues)."""
    if csr.nnz == 0 or np.dtype(value_dtype) == np.float64:
        return plan
    from .cached import COO_TAIL_MAX, CooTail, coo_tail_from_csr
    from .costmodel import estimate_seconds

    if isinstance(plan, CooTail) or csr.nnz > COO_TAIL_MAX:
        return plan
    coo = coo_tail_from_csr(csr, value_dtype=value_dtype)
    return coo if estimate_seconds(coo) < estimate_seconds(plan) else plan


def _cheaper(cand, plan):
    """``cand`` when the cost model prices it below ``plan``."""
    from .costmodel import estimate_seconds

    if cand is not None and estimate_seconds(cand) < estimate_seconds(plan):
        return cand
    return plan


def _auto_sell_plan(csr: CSR, *, value_dtype, max_window_blocks,
                    lane_rows, positions, pad_value: float = 0.0,
                    allow_cached: bool = True,
                    plus_times: bool = True):
    """Pick a SELL-family plan.  ``plus_times``: the plan will run under
    plus-times, so duplicate entries may be merged by summing them."""
    lens = np.diff(np.asarray(csr.indptr, dtype=np.int64))
    kw = dict(value_dtype=value_dtype, lane_rows=lane_rows,
              positions=positions, max_window_blocks=max_window_blocks,
              pad_value=pad_value)
    split = None
    sigma = None
    if lens.size and lens.max() > 0:
        mean = max(1.0, float(lens.mean()))
        mx = float(lens.max())
        if mx / mean > 8.0:
            split = int(max(positions,
                            _cdiv(int(mean * 4), positions) * positions))
            sigma = lane_rows * 8
            # skewed rows with bounded spans: the chunk plan
            # (formats/chunk.py) packs each row block against column
            # windows of at most BUCKET_KS[-1] blocks; rows wider than
            # that would fragment into near-empty tiles, so it is only
            # built for matrices whose typical row fits one window
            if np.dtype(value_dtype) != np.float64 and \
                    lane_rows == 128 and positions == 8:
                from . import analysis
                from .chunk import BUCKET_KS, build_chunk_plan

                spans = analysis.row_spans(csr)[lens > 0]
                if spans.size and \
                        float(np.median(spans)) <= BUCKET_KS[-1] * 128:
                    cp = build_chunk_plan(
                        csr, value_dtype=value_dtype, pad_value=pad_value,
                        merge_duplicates=plus_times)
                    alt = build_sell_plan(csr, sigma=sigma, split=split,
                                          **kw)
                    if cp is not None and _cheaper(cp, alt) is cp:
                        return cp
        elif float(lens.std()) > mean:
            sigma = lane_rows * 8
        elif mx >= 1.5 * positions and mx <= 3.0 * mean:
            # regular rows: a uniform split to 16-nnz sub-rows makes every
            # slice exactly one group of tiles, so the tile -> slice fold
            # is a reshape and the row fixup a lane fold (no scatter);
            # fill cost is bounded by the rows' regularity
            usplit = 2 * positions
            if mx > usplit * lane_rows:
                # would need more sub-rows than lanes (build_sell_plan
                # rejects it); very long regular rows take the plain path
                return build_sell_plan(csr, **kw)
            pu = build_sell_plan(csr, split=usplit, uniform_split=True,
                                 window_group_tiles=max(
                                     1, _cdiv(usplit, positions)), **kw)
            # gate on fill over the real tiles
            real_slots = pu.stats.num_slices * _cdiv(usplit, positions) * \
                positions * lane_rows
            if pu.stats.window_blocks and \
                    pu.stats.nnz >= 0.5 * real_slots:
                return pu
    p = build_sell_plan(csr, sigma=sigma, split=split, **kw)
    if p.stats.window_blocks or p.stats.nnz == 0:
        # bounded column spans: the plain layout's gathers stay local
        return p
    if _cdiv(csr.shape[1], 128) <= NARROW_X_BLOCKS:
        return p
    # wide and locality-poor: the maxAlive / maxColSpan analyses (in
    # their CSR duals: column working set / per-row column span,
    # ``SparseMatrix.cpp:92-119``) propose alternatives, and the cost
    # model decides — the reference's core selection thesis
    from . import analysis
    from .cached import (COO_TAIL_MAX, _compact_full_cover,
                         coo_tail_from_csr)

    single = np.dtype(value_dtype) != np.float64
    if single and (csr.nnz <= (1 << 20)
                   or analysis.column_working_set(csr) <= 2048):
        # a narrow set of live columns: one compact tier gathers from a
        # small, cache-resident x
        p = _cheaper(_compact_full_cover(csr, kw), p)
    # striping width from the span distribution: stripes just wide
    # enough for 95% of rows keep K small without exploding the piece
    # count
    spans = analysis.row_spans(csr)
    nz_spans = spans[lens > 0]
    p95 = int(np.percentile(nz_spans, 95)) if nz_spans.size else 0
    sw = max_window_blocks * 128
    if 0 < p95 <= sw // 2:
        sw = max(256, 1 << int(np.ceil(np.log2(max(p95, 1)))))
    # estimate striping overhead: pieces ~= distinct (row, stripe) pairs
    idx = np.asarray(csr.indices, dtype=np.int64) & 0x3FFFFFFF
    nz_row = np.repeat(np.arange(csr.shape[0], dtype=np.int64), lens)
    stripe = idx // sw
    changes = np.ones(idx.shape[0], dtype=bool)
    changes[1:] = (nz_row[1:] != nz_row[:-1]) | (stripe[1:] != stripe[:-1])
    pieces = int(changes.sum())
    if pieces and csr.nnz / pieces >= 4.0:
        ps = build_sell_plan(csr, sigma=sigma, split=split,
                             stripe_width=sw, **kw)
        if ps.stats.window_blocks:
            p = _cheaper(ps, p)
    if single and csr.nnz <= COO_TAIL_MAX:
        p = _cheaper(coo_tail_from_csr(csr, value_dtype=value_dtype), p)
    if allow_cached and single:
        # a column-popularity hot/cold split (CachedPlan — the
        # vector-cache analog) when a small working set covers enough of
        # the nonzeros
        from .cached import build_cached_plan

        p = _cheaper(build_cached_plan(
            csr, value_dtype=value_dtype,
            max_window_blocks=max_window_blocks, lane_rows=lane_rows,
            positions=positions, pad_value=pad_value), p)
    return p


def validate_plan(plan: SellPlan, a=None) -> None:
    """Debug-mode invariant checks (host-side).

    The reference prevents races by construction and *counts* hazard events
    rather than hiding them (SURVEY.md §5: UniqueQueue/IssueWindow
    interlocks, pending-write counters).  Our layout makes conflicts
    impossible; this validator asserts exactly the invariants the kernels
    rely on, so a corrupted or hand-built plan fails loudly instead of
    producing silent wrong answers:

    * tile_slice nondecreasing, within [0, num_slices);
    * every column index within the matrix and, when the window kernel is
      enabled, within its step's K-block window;
    * row_map entries within [0, rows];
    * every (subrow, position) slot used at most once (no duplicate
      accumulation targets — the no-hazard guarantee);
    * optional: nonzero multiset matches the source container ``a``.
    """
    T, P, R = plan.vals.shape
    if plan.stats.double:
        P = plan.positions
    B = TILES_PER_STEP
    ts = np.asarray(plan.tile_slice)
    if ts.shape != (T,):
        raise ValueError("tile_slice shape mismatch")
    if (np.diff(ts) < 0).any():
        raise ValueError("tile_slice must be nondecreasing")
    if ts.min() < 0 or ts.max() >= plan.num_slices:
        raise ValueError("tile_slice out of range")

    cols = np.asarray(plan.cols)
    vals = np.asarray(plan.vals)
    if plan.stats.double:      # rejoin the hi/lo channel pairs to f64
        vals = vals[:, :P].astype(np.float64) + vals[:, P:]
    pad = plan.stats.pad_value
    live = (vals != pad) if np.isfinite(pad) else np.isfinite(vals)
    if live.any():
        live_cols = cols[live]
        if live_cols.min() < 0 or live_cols.max() >= plan.shape[1]:
            raise ValueError("column index out of matrix range")
    K = plan.stats.window_blocks
    if K > 0:
        wb = np.asarray(plan.window_base).astype(np.int64)
        step_of_tile = np.arange(T) // plan.stats.group_tiles
        lo = wb[step_of_tile] * plan.stats.window_grain
        ok = ~live | ((cols >= lo[:, None, None]) &
                      (cols < (lo + K * 128)[:, None, None]))
        if not ok.all():
            raise ValueError("nonzero outside its step's x window")
        cw = np.asarray(plan.cols_win).astype(np.int64)
        if cw.shape != (T, P, R):
            raise ValueError("cols_win shape mismatch")
        if cw.min() < 0 or cw.max() >= K * 128:
            raise ValueError("cols_win offset outside window")
        if not np.array_equal(cw[live], (cols - lo[:, None, None])[live]):
            raise ValueError("cols_win inconsistent with cols/window_base")

    rm = np.asarray(plan.row_map)
    if rm.min() < 0 or rm.max() > plan.shape[0]:
        raise ValueError("row_map out of range")

    if a is not None:
        csr = _as_csr(a)
        want = np.sort(np.asarray(csr.data)[np.asarray(csr.data) != 0])
        got = np.sort(vals[live])
        if want.shape != got.shape or not np.allclose(want, got):
            raise ValueError("plan nonzero multiset differs from source")
