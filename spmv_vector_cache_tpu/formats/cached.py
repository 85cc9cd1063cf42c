"""Cached plans: the vector-cache / BufferSel analog for locality-poor
matrices.

The reference's answer to a result vector that does not fit on chip is a
*cache* in front of DDR: the working set stays in BRAM and misses pay
memory latency (``chisel/cache-new/NoWMVectorCache.scala``,
``chisel/frontend/SpMVFrontendBufferSel.scala:15-300`` — route each
operand by ``id < ocmDepth`` to the on-chip pipe, everything else to the
DDR pipe).  In the CSR dual the irregularly-accessed vector is **x**, and
the plan can do what the reference's cache does: measure column
popularity up front and split the matrix by it:

* **hot** nonzeros — those in the most-referenced columns — are remapped
  onto a compact column domain of at most ``max_hot`` entries, so their
  gathers read a small x that stays cache-resident regardless of the
  original matrix's locality.  One small ``x[hot_cols]`` gather per apply
  stands in for the cache fill (the init phase of
  ``HardwareSpMVNewCache.cpp:46-56``).
* **cold** nonzeros — the popularity tail — gather from the full x (the
  BufferNone / random-access-port analog,
  ``SpMVFrontendBufferNone.scala:9-175``): slower per element, but they
  are few when popularity is skewed.

Power-law column popularity (web/social/circuit matrices — the
reference's own webbase-1M suite entry, ``matrices/matrixutils.py:18``)
makes the hot share large: at Zipf exponent ~2, a 2048-column hot set
covers >99% of the nonzeros of a 1M-column matrix.  ``coverage`` is the
plan-time hit-rate prediction — the analog of the reference's
readMissCount observability (``NoWMVectorCache.scala:129-134``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import jax
import numpy as np

from .containers import CSR
from .plan import SellPlan, _as_csr

Array = Any


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class CachedPlan:
    """Hot/cold split of one matrix: ``y = hot(x[hot_cols]) + cold(x)``.

    ``hot`` is a :class:`SellPlan` over the compact remapped column
    domain (shape ``(rows, hot_size)``); ``cold`` covers the residual
    nonzeros on the original column domain, or ``None`` when the hot set
    covers everything.  ``hot_cols`` holds the original column ids of the
    hot set in ascending order (so remapping preserves within-row column
    order)."""

    hot: SellPlan
    cold: Optional[Any]       # SellPlan, CachedPlan or CooTail
    hot_cols: Array                    # (hot_size,) int32, ascending
    shape: Tuple[int, int]
    coverage: float                    # hot nnz / total nnz (hit rate)

    def tree_flatten(self):
        return (self.hot, self.cold, self.hot_cols), (self.shape,
                                                      self.coverage)

    @classmethod
    def tree_unflatten(cls, aux, children):
        hot, cold, hot_cols = children
        return cls(hot=hot, cold=cold, hot_cols=hot_cols, shape=aux[0],
                   coverage=aux[1])

    def to_device(self):
        import jax.numpy as jnp

        return CachedPlan(
            hot=self.hot.to_device(),
            cold=self.cold.to_device() if self.cold is not None else None,
            hot_cols=jnp.asarray(self.hot_cols), shape=self.shape,
            coverage=self.coverage)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class CooTail:
    """Tiny-residue COO: ``y[rows_idx[i]] (+)= vals[i] (x) x[cols[i]]``.

    For small residues one element gather + segment scatter beats a
    tiled layout, which still allocates one lane per *matrix row*.  This
    is the representation for cache residues — the trickle of accesses
    past the last tier, priced like the reference's per-operand DDR
    fallback (``SpMVFrontendBufferNone.scala:9-175``)."""

    vals: Array               # (nnz,) value dtype
    cols: Array               # (nnz,) int32
    rows_idx: Array           # (nnz,) int32
    shape: Tuple[int, int]

    def tree_flatten(self):
        return (self.vals, self.cols, self.rows_idx), (self.shape,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        vals, cols, rows_idx = children
        return cls(vals=vals, cols=cols, rows_idx=rows_idx, shape=aux[0])

    def to_device(self):
        import jax.numpy as jnp

        return CooTail(vals=jnp.asarray(self.vals),
                       cols=jnp.asarray(self.cols),
                       rows_idx=jnp.asarray(self.rows_idx),
                       shape=self.shape)

    @property
    def nnz(self) -> int:
        return int(self.vals.shape[0])


#: residues below this many nonzeros run as CooTail
COO_TAIL_MAX = 65536


def coo_tail_from_csr(csr: CSR, value_dtype=np.float32) -> CooTail:
    lens = np.diff(np.asarray(csr.indptr, dtype=np.int64))
    rows_idx = np.repeat(np.arange(csr.shape[0], dtype=np.int32),
                         lens.astype(np.int64))
    return CooTail(
        vals=np.asarray(csr.data).astype(value_dtype),
        cols=(np.asarray(csr.indices, dtype=np.int64)
              & 0x3FFFFFFF).astype(np.int32),
        rows_idx=rows_idx, shape=csr.shape)


def column_frequency(csr: CSR) -> np.ndarray:
    """Per-column nonzero counts — the popularity analysis that predicts
    cache hit rates (the role ``maxAlive``/``maxColSpan`` play for the
    reference's buffer sizing, ``SparseMatrix.cpp:92-119``)."""
    indices = np.asarray(csr.indices, dtype=np.int64) & 0x3FFFFFFF
    return np.bincount(indices, minlength=csr.shape[1])


def hot_set_coverage(csr: CSR, sizes=(256, 512, 1024, 2048, 4096)
                     ) -> dict:
    """Fraction of nnz covered by the top-k columns, for each k — the
    plan-time design-space sweep (cf. the reference's ocmDepth sweeps,
    ``gen-newcache.sh:3-11``)."""
    counts = column_frequency(csr)
    nnz = max(1, int(counts.sum()))
    srt = np.sort(counts)[::-1]
    cum = np.cumsum(srt)
    return {int(k): float(cum[min(k, len(cum)) - 1]) / nnz for k in sizes}


def build_cached_plan(a, *, max_hot: int = 16384,
                      min_coverage: float = 0.5,
                      value_dtype=np.float32,
                      max_window_blocks: int = 16,
                      lane_rows: int = 128, positions: int = 8,
                      pad_value: float = 0.0,
                      levels: int = 3) -> Optional[CachedPlan]:
    """Split by column popularity; None when the matrix has no working
    set (the ``max_hot`` most popular columns cover less than
    ``min_coverage`` of the nonzeros, or less than twice their share of
    the live columns).

    The hot set is the ``max_hot`` most popular columns (fewer when fewer
    are populated): a compact x of that size stays cache-resident, so the
    largest set covers the most nonzeros at the cheap gather cost.
    Whether the split pays against the plain layout is the cost model's
    call (``formats/costmodel.py``; ``plan.auto_plan`` compares).  The
    cold tail recurses into up to ``levels - 1`` further cache levels
    (the popularity tail of a power-law is itself power-law), ending in a
    plain SELL plan."""
    csr = _as_csr(a)
    rows, cols = csr.shape
    if csr.nnz == 0 or cols <= max_hot:
        return None
    counts = column_frequency(csr)
    order = np.argsort(counts, kind="stable")[::-1]
    live = int(np.count_nonzero(counts))
    hot_size = min(max_hot, live)
    nnz = int(counts.sum())
    coverage = float(counts[order[:hot_size]].sum()) / nnz
    if coverage < min_coverage or (
            hot_size < live and coverage < 2.0 * hot_size / live):
        # too little covered, or no column much more popular than the
        # average live one: no working set to cache
        return None
    hot_ids = np.sort(order[:hot_size]).astype(np.int64)

    # split nonzeros by membership; remap hot columns ascending so CSR
    # indices stay sorted within rows
    remap = np.full(cols, -1, np.int64)
    remap[hot_ids] = np.arange(hot_size)
    indices = np.asarray(csr.indices, dtype=np.int64) & 0x3FFFFFFF
    data = np.asarray(csr.data)
    indptr = np.asarray(csr.indptr, dtype=np.int64)
    m = remap[indices]
    is_hot = m >= 0
    lens = np.diff(indptr)
    nz_row = np.repeat(np.arange(rows, dtype=np.int64), lens)
    hot_lens = np.bincount(nz_row[is_hot], minlength=rows)
    hot_csr = CSR(
        data=data[is_hot], indices=m[is_hot].astype(np.int32),
        indptr=np.concatenate(([0], np.cumsum(hot_lens))).astype(np.int32),
        shape=(rows, hot_size))
    from .plan import _auto_sell_plan

    cold_nnz = int((~is_hot).sum())
    kw = dict(value_dtype=value_dtype, lane_rows=lane_rows,
              positions=positions, max_window_blocks=max_window_blocks,
              pad_value=pad_value)
    hot_plan = _auto_sell_plan(hot_csr, allow_cached=False, **kw)
    cold_plan = None
    if cold_nnz:
        cold_csr = CSR(
            data=data[~is_hot], indices=indices[~is_hot].astype(np.int32),
            indptr=np.concatenate(([0], np.cumsum(lens - hot_lens))
                                  ).astype(np.int32),
            shape=(rows, cols))
        cold_plan = _cold_plan(cold_csr, kw, levels)
    return CachedPlan(hot=hot_plan, cold=cold_plan,
                      hot_cols=hot_ids.astype(np.int32),
                      shape=(rows, cols),
                      coverage=float(nnz - cold_nnz) / nnz)


#: a working set of at most this many distinct columns collapses into
#: one full-coverage compact tier (no residual) instead of further
#: levels: its x (32 KB) stays cache-resident
FULL_COVER_MAX = 8192


def _compact_full_cover(csr: CSR, kw: dict) -> Optional[CachedPlan]:
    """One tier covering 100%: remap every nonzero column into a compact
    domain.  Applies whenever the distinct-column count is small, no
    matter how the popularity is distributed (the degenerate multi-level
    case: the whole working set fits the last tier)."""
    from .plan import _auto_sell_plan

    counts = column_frequency(csr)
    nz_cols = np.flatnonzero(counts)
    if (nz_cols.shape[0] == 0 or nz_cols.shape[0] > FULL_COVER_MAX
            or nz_cols.shape[0] == csr.shape[1]):   # nothing to compact
        return None
    rows, cols = csr.shape
    remap = np.full(cols, -1, np.int64)
    remap[nz_cols] = np.arange(nz_cols.shape[0])
    indices = np.asarray(csr.indices, dtype=np.int64) & 0x3FFFFFFF
    hot_csr = CSR(data=np.asarray(csr.data),
                  indices=remap[indices].astype(np.int32),
                  indptr=np.asarray(csr.indptr),
                  shape=(rows, int(nz_cols.shape[0])))
    hot_plan = _auto_sell_plan(hot_csr, allow_cached=False, **kw)
    return CachedPlan(hot=hot_plan, cold=None,
                      hot_cols=nz_cols.astype(np.int32),
                      shape=(rows, cols), coverage=1.0)


def _cold_plan(cold_csr: CSR, kw: dict, levels: int):
    """Plan the popularity tail.

    A power-law tail is itself power-law, so another cache level can keep
    winning until the remainder is small (the multi-level analog of the
    reference's single BRAM tier).  A tail whose distinct columns fit
    one tier collapses into a full-coverage compact level; small residues
    run as :class:`CooTail`; the rest as a plain SELL plan."""
    from .plan import _auto_sell_plan

    if cold_csr.nnz <= (1 << 20):
        fc = _compact_full_cover(cold_csr, kw)
        if fc is not None:
            return fc
    if cold_csr.nnz <= COO_TAIL_MAX:
        return coo_tail_from_csr(cold_csr, value_dtype=kw["value_dtype"])
    if levels > 1:
        cp = build_cached_plan(cold_csr, min_coverage=0.3,
                               levels=levels - 1, **kw)
        if cp is not None:
            return cp
    return _auto_sell_plan(cold_csr, allow_cached=False, **kw)
