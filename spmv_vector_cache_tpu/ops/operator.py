"""SparseOperator — the user-facing handle (the reference's ``SpMV`` class).

The reference models a problem as an object holding (A, x, y) with
``exec()`` and a stats surface (``software/SpMV.h:8-35``), specialized per
execution backend (software / per-bitfile hardware variants) and built by
a factory probing what is loaded (``HWSpMVFactory.cpp:20-38``).  Here the
operator owns the planned matrix and exposes matvec / matmat, a stats
registry, and solver-ready closures; the "factory" is the plan-driven
executor selection with an optional plan-parameter sweep.
"""

from __future__ import annotations

import time
from typing import Any, Optional

import jax.numpy as jnp
import numpy as np

from ..formats import analysis
from ..formats.plan import SellPlan, auto_plan
from ..utils.stats import StatRegistry
from . import reference
from .spmv_exec import spmv_plan
from .strategy import select_strategy

Array = Any


class SparseOperator:
    """A planned sparse matrix ready for repeated application.

    >>> op = SparseOperator.from_matrix(a)          # plans + selects
    >>> y = op @ x                                  # device SpMV
    >>> res = cg(op.matvec, b)                      # solver-ready
    """

    def __init__(self, plan, matrix=None, semiring: str = "plus_times"):
        from ..formats.cached import CachedPlan, CooTail
        from ..formats.dia import HybridPlan
        from . import semiring as sr

        self.plan = plan
        self.semiring = sr.get(semiring).name
        #: the executor that runs the plan (``strategy.select_strategy``)
        self.strategy = select_strategy(plan)
        self._matrix = matrix              # optional original container
        stats_src = plan.dia if isinstance(plan, HybridPlan) else (
            plan.hot if isinstance(plan, CachedPlan) else plan)
        if isinstance(stats_src, CooTail):
            self.stats = StatRegistry({"nnz": stats_src.nnz})
        else:
            self.stats = StatRegistry(
                {k: v for k, v in stats_src.stats.as_dict().items()
                 if isinstance(v, (int, float))})
        for s in ("sell", "dia", "cached", "coo", "chunk"):
            self.stats[f"strategy_{s}"] = int(self.strategy == s)
        if isinstance(plan, CachedPlan):
            self.stats["cache_coverage"] = plan.coverage
            self.stats["cache_hot_cols"] = int(plan.hot_cols.shape[0])
        # plan-derived per-execution event counters (the reference's
        # readMissCount/StateProfiler role, SpMVAcceleratorNewCache.scala
        # :113-130): what one apply will actually do on device
        from .strategy import execution_counters, plan_bytes_per_apply
        for k, v in execution_counters(plan).items():
            self.stats[k] = v
        self.stats["bytes_per_apply"] = plan_bytes_per_apply(plan)

    # -- construction -----------------------------------------------------
    @classmethod
    def from_matrix(cls, a, *, value_dtype=np.float32, tune: bool = False,
                    semiring: str = "plus_times",
                    tune_store: "str | None" = None,
                    **plan_kwargs) -> "SparseOperator":
        """Plan ``a`` (any container); the plan family picks the executor.

        ``tune=True`` runs the timing sweep (the gen-*.sh bitfile-sweep
        role) instead of the structure heuristic alone: the
        plan-*parameter* sweep of :func:`..ops.tune.autotune_plan` (DIA
        vs SELL, split, stripe width, cache tier cap).  ``tune_store``
        persists winners keyed by structural signature.  ``semiring``
        selects the algebra; the plan's padding is built to match.
        """
        t0 = time.perf_counter()
        if tune and not plan_kwargs:
            from .tune import autotune_plan

            res = autotune_plan(a, value_dtype=value_dtype,
                                semiring=semiring, store=tune_store)
            plan = res.plan
        else:
            plan = auto_plan(a, value_dtype=value_dtype,
                             semiring=semiring, **plan_kwargs)
            res = None
        t_plan = time.perf_counter() - t0
        op = cls(plan.to_device(), matrix=a, semiring=semiring)
        op.stats["plan_seconds"] = t_plan   # per-phase timing (the SCU
        # timer's preprocessing-phase role, SoftwareSpMV.cpp:72-94)
        if res is not None:
            op.stats["tuned"] = int(res.best != "auto")
            for e in res.table:
                op.stats[f"tune_{e.name}_gnnz_per_s"] = e.gnnz_per_s
        return op

    # -- application ------------------------------------------------------
    @property
    def shape(self):
        return self.plan.shape

    def matvec(self, x: Array) -> Array:
        return spmv_plan(self.plan, x, semiring=self.semiring)

    def matmat(self, b: Array) -> Array:
        """Multi-RHS ``Y = A @ B`` — the plan's SpMM executor when its
        family has one, the reference path otherwise."""
        from .spmm_exec import spmm_plan, spmm_supported

        if spmm_supported(self.plan) or self._matrix is None:
            return spmm_plan(self.plan, b)
        return reference.spmm(self._matrix, b)

    def __matmul__(self, x: Array) -> Array:
        # no jnp conversion here: a float64 x must reach the double-float
        # plans unrounded
        if np.ndim(x) == 1:
            return self.matvec(x)
        return self.matmat(x)

    def exec(self, x: Array, y: Optional[Array] = None) -> Array:
        """Timed application with stat recording (SpMV::exec role,
        ``SoftwareSpMV.cpp:50-70``): returns ``y (+)= A @ x``."""
        t0 = time.perf_counter()
        out = self.matvec(x)
        out_host = np.asarray(out)          # sync (D2H)
        dt = time.perf_counter() - t0
        from .strategy import plan_nnz
        if "first_exec_seconds" not in self.stats:
            # first call carries compilation — record it separately (the
            # plan/compile/execute phase split)
            self.stats["first_exec_seconds"] = dt
        self.stats["spmvtime"] = dt
        self.stats["gnnz_per_s"] = plan_nnz(self.plan) / dt / 1e9
        if y is not None:
            out_host = out_host + np.asarray(y)
        return out_host

    def audit(self, x: Optional[Array] = None, *, iters: int = 20,
              stream_bw: Optional[float] = None) -> dict:
        """Achieved-vs-peak roofline audit.

        The analog of the reference's activeCycles/totalCycles +
        bytes/cycle counters (``HardwareSpMVNewCache.cpp:183-187``,
        ``TestSpMVBackend.cpp:100-102``): times a chained run with
        two-point marginal timing, models the bytes one apply moves, and
        records Gnnz/s, achieved GB/s, and (when ``stream_bw`` is given
        or measured) the roofline fraction into ``self.stats``.
        """
        import jax

        from ..utils import roofline
        from .strategy import plan_bytes_per_apply, plan_nnz

        rows, cols = self.plan.shape
        if x is None:
            x = np.ones(cols, np.float32)
        x = jnp.asarray(x)
        square = rows == cols

        def make(n):
            @jax.jit
            def go(plan, v):
                def body(_, u):
                    w = spmv_plan(plan, u, semiring=self.semiring)
                    if square:
                        return w / jnp.maximum(jnp.linalg.norm(w), 1e-30)
                    # rectangular: keep the loop-carried dependency through
                    # a negligible scalar so XLA cannot hoist the matvec
                    return u * (1 + w.reshape(-1)[0] * 1e-30)
                return jax.lax.fori_loop(0, n, body, v)[:1]
            return lambda: go(self.plan, x)

        dt = roofline.time_marginal(make, i1=iters, i2=3 * iters)
        return roofline.audit(
            self.stats, nnz=plan_nnz(self.plan), seconds=dt,
            bytes_moved=plan_bytes_per_apply(self.plan),
            stream_bw=stream_bw)

    # -- verification -----------------------------------------------------
    def compare_golden(self, x: Array, golden: Array,
                       rtol: float = 1e-4, atol: float = 1e-4) -> int:
        """Count of entries outside tolerance vs a golden result — the
        ``compareGolden``/diffFromGolden stat (``HardwareSpMV.cpp:37-61``,
        tolerance-based per the float policy)."""
        y = np.asarray(self.matvec(x), dtype=np.float64)
        g = np.asarray(golden, dtype=np.float64)
        bad = int((np.abs(y - g) > atol + rtol * np.abs(g)).sum())
        self.stats["diffFromGolden"] = bad
        return bad

    def __repr__(self):
        from .strategy import plan_nnz
        return (f"SparseOperator(shape={self.plan.shape}, "
                f"nnz={plan_nnz(self.plan)}, "
                f"strategy={self.strategy!r}, "
                f"plan={type(self.plan).__name__})")
