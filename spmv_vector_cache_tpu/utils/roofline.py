"""Roofline observatory: measured speed-of-light + kernel audits.

The reference exports activeCycles/totalCycles and a bytes-per-cycle
bandwidth formula from hardware counters (``TestSpMVBackend.cpp:100-102``,
``HardwareSpMVNewCache.cpp:183-187``); the analog here is an achieved-vs-
peak audit where *peak is measured on the spot* (cards and power limits
vary), not read from a spec sheet.  Every timing waits for the device
with ``block_until_ready``.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional

import jax
import numpy as np

from .stats import StatRegistry

Array = Any


def sync(x):
    """Wait until everything producing ``x`` has run on the device."""
    return jax.block_until_ready(x)


def time_chained(make_fn: Callable[[], Any], *, iters: int,
                 repeats: int = 3) -> float:
    """Time ``make_fn`` (a jitted computation that internally chains
    ``iters`` dependent steps and returns a small array).  Returns
    seconds/step, best of ``repeats``."""
    sync(make_fn())  # compile + warm
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        sync(make_fn())
        best = min(best, time.perf_counter() - t0)
    return best / iters


def time_marginal(make_chain: Callable[[int], Callable[[], Any]],
                  i1: int = 30, i2: int = 90, repeats: int = 3) -> float:
    """Per-iteration device time free of fixed dispatch/sync costs.

    ``make_chain(iters)`` returns a nullary callable running ``iters``
    chained steps in one jit.  Every call pays a fixed dispatch and sync
    cost; the two-point difference ``(T(i2) - T(i1)) / (i2 - i1)``
    cancels it, the analog of the reference reading cycle counters around
    only the hot phase (``HardwareSpMVNewCache.cpp:183-187``)."""
    f1, f2 = make_chain(i1), make_chain(i2)
    t1 = time_chained(lambda: f1(), iters=1, repeats=repeats)
    t2 = time_chained(lambda: f2(), iters=1, repeats=repeats)
    dt = (t2 - t1) / (i2 - i1)
    if dt <= 1e-9:
        # the marginal drowned in call-to-call variance (tiny kernels):
        # lengthen the chains 8x so the real per-iteration work dominates
        # instead of reporting the clamp floor as a bogus rate
        f1, f2 = make_chain(8 * i1), make_chain(8 * i2)
        t1 = time_chained(lambda: f1(), iters=1, repeats=repeats)
        t2 = time_chained(lambda: f2(), iters=1, repeats=repeats)
        dt = (t2 - t1) / (8 * (i2 - i1))
    return max(dt, 1e-12)


def measure_stream_bandwidth(nbytes: int = 256 << 20,
                             mode: str = "read") -> float:
    """Measured HBM streaming bandwidth in bytes/s.

    ``mode='read'``: read-only sum-reduction stream (the speed-of-light
    bound for SpMV, whose hot traffic is reads); ``'readwrite'``: scale
    loop moving 2 bytes per element-byte.  Uses marginal timing so the
    fixed dispatch cost does not deflate the result."""
    import jax.numpy as jnp

    n = nbytes // 4
    x = jnp.asarray(np.random.default_rng(0).standard_normal(n)
                    .astype(np.float32))

    if mode == "read":
        def make(iters):
            @jax.jit
            def go(x):
                def body(i, s):
                    return s + jnp.sum(x * (1.0 + 1e-9 *
                                            i.astype(jnp.float32)))
                return jax.lax.fori_loop(0, iters, body,
                                         jnp.float32(0)).reshape(1)
            return lambda: go(x)
        bytes_per_iter = n * 4
    else:
        def make(iters):
            @jax.jit
            def go(x):
                return jax.lax.fori_loop(
                    0, iters,
                    lambda i, v: v * 1.0000001 + 1e-30 *
                    i.astype(jnp.float32), x)[:1]
            return lambda: go(x)
        bytes_per_iter = 2 * n * 4

    dt = time_marginal(make, i1=50, i2=150)
    return bytes_per_iter / dt


def spmv_roofline_nnz_per_s(stream_bw: float, bytes_per_nnz: float = 8.0
                            ) -> float:
    """Speed-of-light nnz/s for a streaming SpMV (vals + cols per nnz)."""
    return stream_bw / bytes_per_nnz


def audit(stats: StatRegistry, *, nnz: int, seconds: float,
          bytes_moved: float, stream_bw: Optional[float] = None) -> Dict:
    """Record an achieved-vs-peak audit into ``stats`` (CSV-able)."""
    gnnz = nnz / seconds / 1e9
    achieved_bw = bytes_moved / seconds
    stats["seconds"] = seconds
    stats["gnnz_per_s"] = gnnz
    stats["achieved_gb_per_s"] = achieved_bw / 1e9
    if stream_bw:
        stats["peak_gb_per_s"] = stream_bw / 1e9
        stats["roofline_fraction"] = achieved_bw / stream_bw
    return stats.as_dict()
