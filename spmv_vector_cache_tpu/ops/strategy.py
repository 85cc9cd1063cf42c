"""Executor selection and per-apply counters.

The reference selects among its five result-vector placement variants by
flashing a different bitfile and probing the accelerator's signature
register (``software/HWSpMVFactory.cpp:20-38``, ``devcfg.cpp``); choice is
guided by matrix analyses (maxAlive/maxColSpan).  Here the plan family
*is* the choice (``formats/plan.auto_plan``), and each family has exactly
one executor in ``ops/``:

===============================  =======================================
reference variant                this library's plan family / executor
===============================  =======================================
BufferAll / BufferSel / caches   ``sell``: gather-reduce over SELL tiles,
                                 x served by the GPU's L1/L2
vector cache (hot set on chip)   ``cached``: hot/cold column split
BufferNone (y always in DDR)     ``coo``: element gather + segment sum
(no analog: structure-specific)  ``dia``: gather-free diagonal slices,
                                 ``chunk``: skewed rows without scatter
===============================  =======================================
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def select_strategy(plan) -> str:
    """Name of the executor that runs ``plan``."""
    from ..formats.cached import CachedPlan, CooTail
    from ..formats.chunk import ChunkPlan
    from ..formats.dia import DiaPlan, HybridPlan

    if isinstance(plan, ChunkPlan):
        return "chunk"
    if isinstance(plan, (DiaPlan, HybridPlan)):
        return "dia"
    if isinstance(plan, CachedPlan):
        return "cached"
    if isinstance(plan, CooTail):
        return "coo"
    return "sell"


def plan_nnz(plan) -> int:
    """Populated nonzeros of any plan type."""
    from ..formats.cached import CachedPlan, CooTail
    from ..formats.chunk import ChunkPlan
    from ..formats.dia import HybridPlan

    if isinstance(plan, ChunkPlan):
        return plan.stats.nnz
    if isinstance(plan, HybridPlan):
        return plan_nnz(plan.dia) + plan_nnz(plan.rest)
    if isinstance(plan, CachedPlan):
        return plan_nnz(plan.hot) + (
            plan_nnz(plan.cold) if plan.cold is not None else 0)
    if isinstance(plan, CooTail):
        return plan.nnz
    return plan.stats.nnz


def execution_counters(plan) -> Dict[str, int]:
    """Plan-derived counters for one apply — the port of the reference's
    per-execution event counters (readMissCount, FIFO levels,
    ``SpMVAcceleratorNewCache.scala:113-130``).  Hazards cannot occur by
    construction, so the observable events are what the executors read
    and write:

    * ``kernels``: fused device kernels launched;
    * ``stream_bytes``: bytes of plan arrays and dense vectors read or
      written once each;
    * ``gathers``: x elements gathered by index (cache-served or not);
    * ``scatter_slots``: elements entering a segment-sum epilogue.
    """
    from ..formats.cached import CachedPlan, CooTail
    from ..formats.chunk import ChunkPlan
    from ..formats.dia import DiaPlan, HybridPlan

    def merge(*cs):
        out: Dict[str, int] = {}
        for c in cs:
            for k, v in c.items():
                out[k] = out.get(k, 0) + v
        return out

    if isinstance(plan, HybridPlan):
        return merge(execution_counters(plan.dia),
                     execution_counters(plan.rest), {"kernels": 1})
    if isinstance(plan, CachedPlan):
        hot = int(plan.hot_cols.shape[0])
        out = merge(execution_counters(plan.hot),
                    execution_counters(plan.cold)
                    if plan.cold is not None else {},
                    {"kernels": 1 + int(plan.cold is not None),
                     "gathers": hot, "stream_bytes": hot * 8})
        # the cache observability surface: predicted hit/miss volumes
        # (readMissCount analog, NoWMVectorCache.scala:129-134)
        out["hot_hits"] = plan_nnz(plan.hot)
        out["cold_misses"] = plan_nnz(plan.cold) if plan.cold else 0
        return out
    rows, cols = plan.shape
    vec = (rows + cols) * 4
    if isinstance(plan, DiaPlan):
        vb = int(np.prod(plan.vals.shape)) * \
            np.dtype(plan.vals.dtype).itemsize
        return {"kernels": 1, "stream_bytes": vb + vec, "gathers": 0,
                "scatter_slots": 0}
    if isinstance(plan, CooTail):
        it = np.dtype(plan.vals.dtype).itemsize
        return {"kernels": 2, "stream_bytes": plan.nnz * (it + 8) + vec,
                "gathers": plan.nnz, "scatter_slots": plan.nnz}
    if isinstance(plan, ChunkPlan):
        tiles = [b.vals for b in plan.buckets] + \
            [h.vals for h in plan.hbuckets]
        slots = sum(int(np.prod(v.shape)) for v in tiles)
        it = np.dtype(tiles[0].dtype).itemsize if tiles else 4
        partials = sum(int(v.shape[0]) for v in tiles) * 128
        out = {"kernels": len(tiles) + 3,
               "stream_bytes": slots * (it + 4) + partials * 8 + vec,
               "gathers": slots, "scatter_slots": partials}
        if plan.residue is not None:
            out = merge(out, execution_counters(plan.residue))
        return out
    st = plan.stats
    T, R = st.num_tiles, plan.lane_rows
    slots = T * plan.positions * R
    vb = int(np.prod(plan.vals.shape)) * np.dtype(plan.vals.dtype).itemsize
    partials = T * R
    kernels, scatter = 1, 0
    if not st.group_slice_identity:              # tile -> slice fold
        kernels += 1
        scatter += partials
    if not (plan.identity_map or st.uniform_parts):   # row fixup
        kernels += 1
        scatter += int(plan.row_map.shape[0])
    return {"kernels": kernels,
            "stream_bytes": vb + slots * 4 + partials * 4 * 2 + vec,
            "gathers": slots * (2 if st.double else 1),
            "scatter_slots": scatter}


def plan_bytes_per_apply(plan) -> int:
    """Bytes one SpMV moves — the denominator of the achieved-vs-peak
    audit (the reference's bytes/cycle formula, TestSpMVBackend.cpp:100).
    Counts the streamed plan arrays, the dense vectors, and the partial
    sums written and read back; gathers are cache traffic and are counted
    separately (:func:`execution_counters`)."""
    return execution_counters(plan)["stream_bytes"]
