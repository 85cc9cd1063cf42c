"""Plan-parameter autotune: the design-space sweep, persisted.

The reference explores its design space by *synthesizing bitfiles* over
ocmDepth x issueWindow x maxMiss x CMS grids and timing each on hardware
(``gen-newcache.sh:3-11``, ``gen-bufferall.sh:3-8``).  Here a plan
rebuild replaces a synthesis run: :func:`autotune_plan` builds a small
candidate grid around the heuristic plan (DIA vs SELL, uniform-split
factor, stripe width, cache tier cap and depth — each a knob that changes
what the executors read, and the analog of one of the reference's
generator knobs), times every candidate on device, and persists the
winner keyed by a structural signature so later sessions skip the sweep
(the role of the reference's named bitfile library,
``spmv-common.scala:36-40`` config-suffix artifacts).
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

Array = Any


def _time_device(fn, *, iters: int = 10) -> float:
    """Seconds per call of ``fn()``, after one warm-up call, waiting for
    the device with ``block_until_ready``."""
    import jax

    jax.block_until_ready(fn())
    t0 = time.perf_counter()
    for _ in range(iters):
        y = fn()
    jax.block_until_ready(y)
    return (time.perf_counter() - t0) / iters


def plan_signature(a) -> str:
    """Structural fingerprint: matrices with the same signature share a
    winning configuration (the reference keys bitfiles by config suffix;
    we key by the structure that *drives* config choice)."""
    from ..formats.plan import _as_csr

    csr = _as_csr(a)
    lens = np.diff(np.asarray(csr.indptr, dtype=np.int64))
    indices = np.asarray(csr.indices, dtype=np.int64) & 0x3FFFFFFF
    rows, cols = csr.shape
    nnz = max(1, int(indices.shape[0]))
    mean = float(lens.mean()) if lens.size else 0.0
    mx = int(lens.max()) if lens.size else 0
    # coarse popularity + locality features
    top = 0.0
    span = 0
    if nnz > 1:
        counts = np.bincount(indices, minlength=cols)
        top = float(np.sort(counts)[::-1][:2048].sum()) / nnz
        nz_row = np.repeat(np.arange(rows, dtype=np.int64), lens)
        first = np.searchsorted(nz_row, np.arange(rows))
        last = np.searchsorted(nz_row, np.arange(rows), side="right") - 1
        ok = last >= first
        if ok.any():
            span = int(np.median((indices[last[ok]]
                                  - indices[first[ok]])))
    key = (rows, cols, nnz, round(mean, 1), mx, round(top, 2),
           span // 128)
    return "sig_" + "_".join(str(k) for k in key)


@dataclasses.dataclass
class TuneEntry:
    name: str
    seconds: float
    gnnz_per_s: float
    params: Dict[str, Any]


@dataclasses.dataclass
class TuneResult:
    signature: str
    best: str
    plan: Any
    table: List[TuneEntry]

    def as_rows(self) -> List[Dict[str, Any]]:
        return [{"candidate": e.name, "seconds": e.seconds,
                 "gnnz_per_s": round(e.gnnz_per_s, 3),
                 "best": e.name == self.best, **e.params}
                for e in self.table]


def _candidates(a, base_plan, value_dtype, semiring
                ) -> List[Tuple[str, Dict[str, Any],
                                Callable[[], Any]]]:
    """(name, params, builder) triples around the heuristic choice."""
    from ..formats.cached import CachedPlan, build_cached_plan
    from ..formats.dia import DiaPlan, HybridPlan
    from ..formats.plan import SellPlan, auto_plan, build_sell_plan

    cands: List[Tuple[str, Dict[str, Any], Callable[[], Any]]] = [
        ("auto", {}, lambda: base_plan)]

    if isinstance(base_plan, (DiaPlan, HybridPlan)):
        cands.append(("sell", {},
                      lambda: auto_plan(a, value_dtype=value_dtype,
                                        allow_dia=False,
                                        semiring=semiring)))
    elif isinstance(base_plan, SellPlan):
        st = base_plan.stats
        if st.uniform_parts:
            for sp in (8, 16, 32):
                cands.append((f"uniform_split{sp}", {"split": sp},
                              lambda s=sp: build_sell_plan(
                                  a, value_dtype=value_dtype, split=s,
                                  uniform_split=True,
                                  window_group_tiles=max(
                                      1, -(-s // base_plan.positions)))))
        if st.num_stripes > 1:
            sw = st.window_blocks * 128 if st.window_blocks else 2048
            for f in (2, 4):
                cands.append((f"stripe_width{sw * f}",
                              {"stripe_width": sw * f},
                              lambda w=sw * f: build_sell_plan(
                                  a, value_dtype=value_dtype,
                                  stripe_width=w)))
    elif isinstance(base_plan, CachedPlan):
        for mh in (512, 2048, 8192):
            if mh != base_plan.hot_cols.shape[0]:
                cands.append((f"max_hot{mh}", {"max_hot": mh},
                              lambda m=mh: build_cached_plan(
                                  a, max_hot=m,
                                  value_dtype=value_dtype) or base_plan))
        cands.append(("levels1", {"levels": 1},
                      lambda: build_cached_plan(
                          a, levels=1,
                          value_dtype=value_dtype) or base_plan))
    return cands


def autotune_plan(a, *, value_dtype=np.float32,
                  semiring: str = "plus_times", iters: int = 10,
                  store: Optional[str] = None,
                  force: bool = False) -> TuneResult:
    """Sweep plan-parameter candidates on device; persist the winner.

    ``store``: JSON path ({signature: {best, params, table}}); when the
    signature is present and ``force`` is False, the stored winner is
    rebuilt directly with no timing (the reference reuses a synthesized
    bitfile rather than re-running synthesis)."""
    import jax.numpy as jnp

    from ..formats.plan import auto_plan
    from .spmv_exec import spmv_plan
    from .strategy import plan_nnz

    sig = plan_signature(a)
    base = auto_plan(a, value_dtype=value_dtype, semiring=semiring)
    stored = {}
    if store and os.path.exists(store):
        with open(store) as f:
            try:
                stored = json.load(f)
            except ValueError:
                stored = {}
    cands = _candidates(a, base, value_dtype, semiring)
    if not force and sig in stored:
        want = stored[sig]["best"]
        for name, params, build in cands:
            if name == want:
                plan = build()
                return TuneResult(
                    signature=sig, best=want, plan=plan,
                    table=[TuneEntry(name=want, seconds=0.0,
                                     gnnz_per_s=0.0, params=params)])
    x = jnp.asarray(np.ones(a.shape[1], np.float32))
    table: List[TuneEntry] = []
    best_plan, best_name, best_dt = base, "auto", float("inf")
    for name, params, build in cands:
        try:
            plan = build()
        except ValueError:       # layout infeasible for this matrix
            continue
        pd = plan.to_device()
        dt = _time_device(lambda p=pd: spmv_plan(p, x, semiring=semiring),
                          iters=iters)
        nnz = plan_nnz(plan)
        table.append(TuneEntry(name=name, seconds=dt,
                               gnnz_per_s=nnz / dt / 1e9 if dt else 0.0,
                               params=params))
        if dt < best_dt:
            best_plan, best_name, best_dt = plan, name, dt
    res = TuneResult(signature=sig, best=best_name, plan=best_plan,
                     table=table)
    if store:
        stored[sig] = {"best": best_name,
                       "table": [{"name": e.name,
                                  "seconds": e.seconds,
                                  "gnnz_per_s": e.gnnz_per_s}
                                 for e in table]}
        with open(store, "w") as f:
            json.dump(stored, f, indent=1, sort_keys=True)
    return res
