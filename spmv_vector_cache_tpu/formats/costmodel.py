"""Plan cost model: predicted seconds per apply of each plan family on
the GPU executors.

The reference chooses its accelerator variant per matrix by flashing the
bitfile the ``HWSpMVFactory`` maps to the driver's signature probe
(``software/HWSpMVFactory.cpp:20-38``); the analyses that *inform* the
choice (maxAlive / maxColSpan, ``SparseMatrix.cpp:92-119``) predict which
buffer strategy wins.  This module is that prediction for the executors in
``ops/``: every apply is a few fused kernels that

* stream their plan arrays and the dense vectors (bytes / HBM bandwidth),
* gather x once per stored nonzero (cheap while x stays in L2, a memory
  transaction per element once it does not),
* scatter partial sums in their segment-sum epilogues (atomics),

plus a fixed cost per kernel launched inside a jitted chain.  The model
describes the planning target, an NVIDIA H200; it does not look at the
device it runs on.  It is coarse by design: its job is to veto large
mis-selections (a HybridPlan whose residual collapsed to 1% fill, a
striped plan whose epilogue scatter dwarfs its stream), not to replace
measurement.
"""

from __future__ import annotations

from typing import Any

import numpy as np

# --- H200 constants ---------------------------------------------------------
# Measured with ``python -m spmv_vector_cache_tpu.tools.costcal`` on one
# NVIDIA H200 (power limit 700 W), each the slope of a jitted 100-step
# chain.
#: streaming bandwidth of a 1 GiB read + write (bytes/ns): 4141
_BYTES_PER_NS = 4141.0
#: one more kernel per step inside a chained jit, in device time: a
#: profiler trace counted 7 more kernels per step in a chain of 9
#: barrier-separated 1024-element ops than in a chain of 1, and 7.22 us
#: more device-busy time: 1032 ns
_NS_LAUNCH = 1032.0
#: random gather of one 4-byte element from a 4 MB (L2-resident) vector,
#: beyond streaming its index and result: 0.0052 ns
_NS_PER_GATHER_L2 = 0.0052
#: the same from a 1 GiB vector (L2 holds ~5% of it): 0.0236 ns
_NS_PER_GATHER_HBM = 0.0236
#: one element of an unsorted segment sum into 1M segments, beyond
#: streaming its value and id: 0.0049 ns
_NS_PER_SCATTER = 0.0049
#: L2 capacity that decides which gather cost applies
L2_BYTES = 50 << 20


def l2_share(x_bytes: int, cols=None) -> float:
    """Share of the gathers from a vector of ``x_bytes`` that L2 serves.
    All of them while x fits; beyond, the share that falls on the columns
    L2 can hold, taken as the most-gathered ones (``cols``: the gathered
    column ids) — a power law of column popularity keeps its hot columns
    in L2 without any software tier.  Uniform access without ``cols``."""
    if x_bytes <= L2_BYTES:
        return 1.0
    k = L2_BYTES // 4
    if cols is None:
        return L2_BYTES / x_bytes
    counts = np.bincount(np.asarray(cols, np.int64).ravel())
    if counts.size <= k:
        return 1.0
    top = np.partition(counts, counts.size - k)[counts.size - k:]
    return float(top.sum()) / max(1, int(counts.sum()))


def gather_ns(x_bytes: int, cols=None) -> float:
    """ns per gathered element from a vector of ``x_bytes``: the L2 cost
    for the share of gathers L2 serves (:func:`l2_share`), the HBM cost
    for the rest."""
    hit = l2_share(x_bytes, cols)
    return hit * _NS_PER_GATHER_L2 + (1.0 - hit) * _NS_PER_GATHER_HBM


def estimate_seconds(plan: Any) -> float:
    """Predicted seconds per apply inside a jitted chain."""
    name = type(plan).__name__
    if name == "SellPlan":
        return _sell_ns(plan) * 1e-9
    if name == "DiaPlan":
        return _dia_ns(plan) * 1e-9
    if name == "HybridPlan":
        return (estimate_seconds(plan.dia) + estimate_seconds(plan.rest)
                + _NS_LAUNCH * 1e-9)
    if name == "CachedPlan":
        hot = int(plan.hot_cols.shape[0])
        t = estimate_seconds(plan.hot) + (
            _NS_LAUNCH + hot * gather_ns(plan.shape[1] * 4,
                                         plan.hot_cols)) * 1e-9
        if plan.cold is not None:
            t += estimate_seconds(plan.cold) + _NS_LAUNCH * 1e-9
        return t
    if name == "CooTail":
        return _coo_ns(plan) * 1e-9
    if name == "ChunkPlan":
        return _chunk_ns(plan) * 1e-9
    raise ValueError(f"no cost model for plan type {name}")


def _tiles_ns(slots: int, nnz: int, val_bytes: int, idx_bytes: int,
              x_bytes: int, cols=None) -> float:
    """The fused gather-multiply-reduce over SELL-shaped tiles: stream
    values and indices, gather x for every stored nonzero (padding slots
    read a cached x[0]), write one partial per tile lane."""
    return (slots * (val_bytes + idx_bytes) / _BYTES_PER_NS
            + nnz * gather_ns(x_bytes, cols))


def _sell_ns(plan) -> float:
    st = plan.stats
    T, R = st.num_tiles, plan.lane_rows
    slots = T * plan.positions * R
    rows, cols = plan.shape
    vb = np.dtype(plan.vals.dtype).itemsize
    if st.double:
        vb, gathers = 8, 2 * st.nnz            # hi/lo channels
    else:
        gathers = st.nnz
    t = _NS_LAUNCH + _tiles_ns(slots, gathers, vb, 4, cols * 4, plan.cols)
    partials = T * R
    t += partials * 4 / _BYTES_PER_NS
    if not st.group_slice_identity:             # tile -> slice fold
        t += _NS_LAUNCH + partials * _NS_PER_SCATTER
    if not (plan.identity_map or st.uniform_parts):
        t += _NS_LAUNCH + plan.row_map.shape[0] * _NS_PER_SCATTER
    t += rows * 4 / _BYTES_PER_NS
    if st.double:
        # compensated slice/row folds: a short fori_loop of small kernels
        t += 4 * _NS_LAUNCH
    return t


def _dia_ns(plan) -> float:
    vals = plan.vals
    nbytes = int(np.prod(vals.shape)) * np.dtype(vals.dtype).itemsize
    rows, cols = plan.shape
    # one fused loop over all diagonals; x slices overlap and come from
    # L2, so x and y cross HBM about once each
    return _NS_LAUNCH + (nbytes + (rows + cols) * 4) / _BYTES_PER_NS


def _coo_ns(plan) -> float:
    nnz = plan.nnz
    it = np.dtype(plan.vals.dtype).itemsize
    return (2 * _NS_LAUNCH + nnz * (it + 8) / _BYTES_PER_NS
            + nnz * (gather_ns(plan.shape[1] * 4, plan.cols)
                     + _NS_PER_SCATTER))


def _chunk_ns(plan) -> float:
    """ChunkPlan: each bucket's tiles through the gather-reduce, one
    segment reduction over all tile partials, the lane un-permutation and
    the heavy-row merge."""
    cols = plan.shape[1]
    t = 0.0
    partials = 0
    for b in list(plan.buckets) + list(plan.hbuckets):
        T = int(b.vals.shape[0])
        slots = T * 1024
        nnz = int(np.count_nonzero(np.asarray(b.vals)))
        t += _NS_LAUNCH + _tiles_ns(
            slots, nnz, np.dtype(b.vals.dtype).itemsize, 4, cols * 4,
            getattr(b, "cols", None))
        partials += T * 128
    t += _NS_LAUNCH + partials * _NS_PER_SCATTER
    t += 2 * _NS_LAUNCH + plan.shape[0] * 4 * 2 / _BYTES_PER_NS
    if plan.residue is not None:
        t += estimate_seconds(plan.residue) * 1e9
    return t
