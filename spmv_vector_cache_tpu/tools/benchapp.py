"""Benchmark application: matrix sweep with golden checks.

The role of the reference's interactive benchmark REPL
(``software/main.cpp:146-264``): for every (configuration, matrix) pair it
reconfigures the accelerator, runs a software check pass, runs hardware,
compares against golden, and prints one CSV row.  Here the
"configuration" is the executor ``auto_plan`` picks for the matrix (no
bitfiles to flash), the software check is the numpy host loop, and the
CSV carries the statKeys taxonomy plus roofline audits.

Usage:
  python -m spmv_vector_cache_tpu.tools.benchapp \
      [--iters 10] [--cpu] <matrix-dir>...
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List

import numpy as np


def _chain_marginal(plan, x0, i1: int = 10, i2: int = 40) -> float:
    """Marginal per-apply device time over chained applies.

    Chained fori_loop two-point timing (the report.py/bench.py
    methodology, ``utils/roofline.time_marginal``) cancels fixed
    per-call costs, mirroring the reference reading cycle counters
    around only the hot phase (``HardwareSpMVNewCache.cpp:183-187``)."""
    import jax
    import jax.numpy as jnp

    from ..ops.spmv_exec import spmv_plan
    from ..utils import roofline

    def make(iters):
        @jax.jit
        def go(p, x):
            def body(_, v):
                w = spmv_plan(p, v)
                return w / jnp.maximum(jnp.max(jnp.abs(w)), 1e-30)
            return jax.lax.fori_loop(0, iters, body, x)[:1]
        return lambda: go(plan, x0)

    return roofline.time_marginal(make, i1=i1, i2=i2)


def run_sweep(matrix_dirs: List[str], iters: int, out=sys.stdout) -> int:
    import jax.numpy as jnp

    from ..formats import refio
    from ..formats.plan import auto_plan
    from ..ops import reference
    from ..ops.spmv_exec import spmv_plan
    from ..ops.strategy import (execution_counters,
                                plan_bytes_per_apply, plan_nnz,
                                select_strategy)
    from ..utils.stats import StatRegistry, csv_rows

    registries, extras = [], []
    rc = 0
    for d in matrix_dirs:
        name = os.path.basename(os.path.normpath(d))
        try:
            a = refio.load_reference_matrix(d)
        except (OSError, ValueError) as e:
            print(f"error: cannot load {d}: {e}", file=sys.stderr)
            rc = 1
            continue
        gold = refio.load_golden(d)
        x = np.ones(a.shape[1], dtype=np.float32)
        # software check pass (benchmarkSW role, main.cpp:102-144)
        sw = reference.spmv_numpy(a, x.astype(np.float64))
        plan = auto_plan(a).to_device()

        nnz = plan_nnz(plan)
        strat = select_strategy(plan)
        # uniform column set across plan types (Sell/Dia/Hybrid rows
        # must share a CSV schema); plan-type detail goes in `plan`
        stats = StatRegistry({"nnz": nnz})
        y = np.asarray(spmv_plan(plan, jnp.asarray(x)))
        # diffFromGolden (HardwareSpMV.cpp:54-61): count of mismatched
        # entries vs the software pass / golden file
        tol = 1e-4 * max(1.0, float(np.abs(sw).max()))
        diff_sw = int((np.abs(y - sw) > tol).sum())
        diff_gold = (int((np.abs(y - gold) > tol).sum())
                     if gold is not None else -1)
        if diff_sw:
            rc = 1
        dt = _chain_marginal(plan, jnp.asarray(x),
                             i1=iters, i2=4 * iters)
        stats["spmvtime"] = dt
        stats["gnnz_per_s"] = nnz / dt / 1e9
        stats["diffFromSW"] = diff_sw
        stats["diffFromGolden"] = diff_gold
        # per-execution event counters + modeled traffic (the
        # reference CSV's counter columns, HardwareSpMVNewCache.cpp
        # :189-204)
        stats.update(execution_counters(plan))
        bpa = plan_bytes_per_apply(plan)
        stats["bytes_per_apply"] = bpa
        stats["achieved_gb_per_s"] = bpa / dt / 1e9
        registries.append(stats)
        extras.append({"matrix": name, "strategy": strat,
                       "status": "ok" if diff_sw == 0 else "MISMATCH",
                       "plan": type(plan).__name__})
    out.write(csv_rows(registries, extras))
    return rc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("matrices", nargs="+", help="matrix directories "
                    "(reference wire format)")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend")
    args = ap.parse_args(argv)
    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")
    return run_sweep(args.matrices, args.iters)


if __name__ == "__main__":
    raise SystemExit(main())
