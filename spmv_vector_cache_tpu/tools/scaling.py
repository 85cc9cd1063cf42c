"""Weak-scaling harness: 1 chip -> N devices (BASELINE.json config 5).

Measures row-partitioned sharded SpMV at increasing device counts with a
problem that grows proportionally (weak scaling), and reports efficiency
= T(1) / T(N) for N-times the work.  On a multi-GPU host the mesh spans
the cards; on a CPU host the same harness runs functionally over virtual
devices (numbers then characterize the harness, not hardware — every row
names the device it ran on).

Usage:
  XLA_FLAGS=--xla_force_host_platform_device_count=8 \
  python -m spmv_vector_cache_tpu.tools.scaling [--rows-per-device 65536]
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List

import numpy as np


def weak_scaling(rows_per_device: int = 1 << 16, ndiag: int = 17,
                 iters: int = 10, device_counts=None, mode: str = "sell",
                 log=sys.stderr) -> List[Dict[str, Any]]:
    """``mode``: 'sell' (general executor + all-gather/halo) or 'dia'
    (diagonal executor + ppermute halos — the banded fast path)."""
    import jax
    import jax.numpy as jnp
    import scipy.sparse as sp

    from ..formats.convert import from_scipy
    from ..parallel.dia_sharded import (build_sharded_dia_plan,
                                        spmv_dia_sharded)
    from ..parallel.spmv_sharded import (build_sharded_plan, make_mesh,
                                         spmv_sharded)
    from ..utils import roofline

    ndev_avail = len(jax.devices())
    d0 = jax.devices()[0]
    counts = [d for d in (device_counts or (1, 2, 4, 8)) if d <= ndev_avail]
    rng = np.random.default_rng(0)
    results = []
    base_time = None
    for nd in counts:
        n = rows_per_device * nd
        m = sp.spdiags(rng.standard_normal((ndiag, n)).astype(np.float32),
                       list(range(-(ndiag // 2), ndiag // 2 + 1)),
                       n, n).tocsr()
        m.sort_indices()
        a = from_scipy(m.astype(np.float32))
        if mode == "dia":
            spn = build_sharded_dia_plan(a, nd)
            run = lambda s, v: spmv_dia_sharded(s, v, mesh)  # noqa: E731
        else:
            spn = build_sharded_plan(a, nd)
            run = lambda s, v: spmv_sharded(s, v, mesh, mode="auto")  # noqa: E731
        spn = jax.tree.map(jnp.asarray, spn)
        mesh = make_mesh(nd)
        x = jnp.asarray(rng.standard_normal(n).astype(np.float32))

        # correctness gate
        y = np.asarray(run(spn, x))
        ok = np.allclose(y, m.astype(np.float64) @ np.asarray(x),
                         rtol=1e-3, atol=1e-3)

        def make(k):
            @jax.jit
            def chain(spl, xv):
                def body(i, v):
                    w = run(spl, v)
                    return w / jnp.maximum(jnp.linalg.norm(w), 1e-30)
                return jax.lax.fori_loop(0, k, body, xv)[:1]
            return lambda: chain(spn, x)

        dt = roofline.time_marginal(make, i1=iters, i2=3 * iters)
        if base_time is None:
            base_time = dt
        eff = base_time / dt
        row = {"devices": nd, "rows": n, "nnz": a.nnz, "ok": bool(ok),
               "seconds": dt, "gnnz_per_s": a.nnz / dt / 1e9,
               "weak_scaling_efficiency": eff,
               "platform": d0.platform, "device_kind": d0.device_kind}
        results.append(row)
        print(f"devices={nd} ok={ok} {row['gnnz_per_s']:.2f} Gnnz/s "
              f"eff={eff:.2f}", file=log, flush=True)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--rows-per-device", type=int, default=1 << 16)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--mode", choices=("sell", "dia"), default="sell")
    args = ap.parse_args(argv)
    results = weak_scaling(rows_per_device=args.rows_per_device,
                           iters=args.iters, mode=args.mode)
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
