"""Measure the GPU constants of the plan cost model (``formats/costmodel.py``)
and check the model's routing choices against timed plans.

Each constant is the slope of a jitted chain of 100 dependent steps,
timed with ``block_until_ready`` after a warm-up:

* ``bytes_per_ns``: a 1 GiB f32 scale (read + write);
* ``ns_launch``: device time of one more kernel per step, from a
  profiler trace of two chains of small ops separated by
  ``optimization_barrier`` (1 and 9 per step): the difference in
  device-busy time over the difference in kernels counted;
* ``ns_gather_l2`` / ``ns_gather_hbm``: one random element gather from a
  4 MB / a 1 GiB vector, beyond streaming its index and its result;
* ``ns_scatter``: one element of an unsorted segment sum, beyond streaming
  its value and its segment id.

``--check`` builds both candidates of each choice ``auto_plan`` makes with
the model (hybrid or SELL, COO or SELL, chunk or split+sigma SELL, cached
or plain), on the routing tests' own matrix shapes and at full size, and
prints per candidate the predicted and the measured time per apply (a
100-apply chain with the plan as a jit argument) and the kernels per
apply counted in a profiler trace.

    python -m spmv_vector_cache_tpu.tools.costcal           # one JSON line
    python -m spmv_vector_cache_tpu.tools.costcal --check   # + one per matrix
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import tempfile
import time

import numpy as np

#: plan-building knobs ``auto_plan`` passes by default
_KW = dict(value_dtype=np.float32, max_window_blocks=16, lane_rows=128,
           positions=8)


def _fori(step, iters: int):
    """One jit running ``iters`` chained ``step(v, *args)`` calls."""
    import jax

    @jax.jit
    def run(x, *args):
        return jax.lax.fori_loop(0, iters, lambda i, v: step(v, *args), x)
    return run


def _best_seconds(run, *args, repeats: int = 3) -> float:
    import jax

    jax.block_until_ready(run(*args))
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(run(*args))
        best = min(best, time.perf_counter() - t0)
    return best


def _chain_seconds(step, x0, iters: int = 100, repeats: int = 3) -> float:
    """Seconds per step of ``iters`` chained ``step`` calls in one jit."""
    return _best_seconds(_fori(step, iters), x0, repeats=repeats) / iters


def device_kernels(run, *args, steps: int) -> dict:
    """Kernels and device-busy time per step from a profiler trace of one
    call of ``run`` (already compiled and warm) that chains ``steps``
    steps.  Counts the events on the GPU planes' stream lines; busy is the
    union of their intervals."""
    import jax

    with tempfile.TemporaryDirectory() as d:
        with jax.profiler.trace(d):
            jax.block_until_ready(run(*args))
        path = glob.glob(os.path.join(d, "**", "*.xplane.pb"),
                         recursive=True)[0]
        data = jax.profiler.ProfileData.from_file(path)
        spans, lines = [], {}
        for plane in data.planes:
            if not plane.name.startswith("/device:GPU"):
                continue
            for line in plane.lines:
                evs = list(line.events)
                lines[line.name] = len(evs)
                if line.name.startswith("Stream"):
                    spans += [(e.start_ns, e.start_ns + e.duration_ns)
                              for e in evs]
    busy, end = 0.0, -np.inf
    for a, b in sorted(spans):
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    return {"kernels_per_step": len(spans) / steps,
            "busy_us_per_step": busy / steps / 1e3, "trace_lines": lines}


def measure() -> dict:
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    out = {}

    n = 1 << 28                                    # 1 GiB of f32
    big = jnp.asarray(rng.standard_normal(n).astype(np.float32))
    t = _chain_seconds(lambda v: v * 1.0000001, big)
    out["bytes_per_ns"] = 2 * n * 4 / (t * 1e9)

    small = jnp.ones((1024,), jnp.float32)

    def kernels(k):
        def step(v):
            for _ in range(k):
                v = jax.lax.optimization_barrier(v[::-1] * 1.0000001)
            return v
        return step

    # a host clock cannot see a 1 us kernel behind the loop's own cost
    # per step: count the kernels and their device time in a trace
    tr = {}
    for k in (1, 9):
        run = _fori(kernels(k), 100)
        jax.block_until_ready(run(small))
        tr[k] = out[f"trace_launch_chain_k{k}"] = device_kernels(
            run, small, steps=100)
    out["ns_launch"] = (
        (tr[9]["busy_us_per_step"] - tr[1]["busy_us_per_step"]) * 1e3
        / (tr[9]["kernels_per_step"] - tr[1]["kernels_per_step"]))

    m = 1 << 26                                    # gathered elements
    idx_l2 = jnp.asarray(rng.integers(0, 1 << 20, m).astype(np.int32))
    idx_hbm = jnp.asarray(rng.integers(0, n, m).astype(np.int32))
    stream_ns = 8 / out["bytes_per_ns"]            # index in, value out

    for name, src, idx in (("l2", jnp.asarray(
            rng.standard_normal(1 << 20).astype(np.float32)), idx_l2),
            ("hbm", big, idx_hbm)):
        def gather_step(v, src=src, idx=idx):
            # indices depend on the previous step (so the gather cannot be
            # hoisted out of the loop) without changing their values
            bump = (v[0] > 3e38).astype(jnp.int32)
            return jnp.take(src, idx + bump, mode="clip")
        t = _chain_seconds(gather_step, jnp.zeros((m,), jnp.float32))
        out[f"ns_gather_{name}"] = t * 1e9 / m - stream_ns

    seg = jnp.asarray(rng.integers(0, 1 << 20, m).astype(np.int32))

    def scatter_step(v):
        s = jax.ops.segment_sum(v, seg, num_segments=1 << 20)
        return v + s[:1]

    t = _chain_seconds(scatter_step, jnp.ones((m,), jnp.float32))
    out["ns_scatter"] = t * 1e9 / m - stream_ns
    return out


# ---------------------------------------------------------------------------
# the model's routing choices, timed
# ---------------------------------------------------------------------------

def _coo(r, c, shape, rng):
    import scipy.sparse as sp

    from ..formats.convert import from_scipy

    m = sp.csr_matrix((rng.standard_normal(r.shape[0]).astype(np.float32),
                       (r, c)), shape=shape)
    m.sum_duplicates()
    m.sort_indices()
    return from_scipy(m)


def banded_plus_noise(n: int, offs, noise: int, seed: int = 0):
    """Dense diagonals at ``offs`` plus ``noise`` random entries."""
    rng = np.random.default_rng(seed)
    r = np.concatenate([np.arange(n)] * len(offs)
                       + [rng.integers(0, n, noise)])
    c = np.concatenate([np.arange(n) + o for o in offs]
                       + [rng.integers(0, n, noise)])
    keep = (c >= 0) & (c < n)
    return _coo(r[keep], c[keep], (n, n), rng)


def uniform(n: int, density: float, seed: int = 0):
    rng = np.random.default_rng(seed)
    k = int(n * n * density)
    return _coo(rng.integers(0, n, k), rng.integers(0, n, k), (n, n), rng)


def pareto_banded(n: int, cap: int, spread: int = 300, seed: int = 13):
    """Pareto row lengths, columns near the diagonal (bounded spans)."""
    rng = np.random.default_rng(seed)
    lens = np.minimum((rng.pareto(1.2, n) * 8).astype(np.int64) + 1, cap)
    r = np.repeat(np.arange(n), lens)
    c = np.clip((np.abs(rng.standard_normal(r.shape[0])) * spread)
                .astype(np.int64) + r - spread // 2, 0, n - 1)
    return _coo(r, c, (n, n), rng)


def powerlaw_cols(rows: int, cols: int, per_row: int, a: float = 1.6,
                  seed: int = 0):
    """Zipf column popularity, hot columns scattered over the range."""
    rng = np.random.default_rng(seed)
    ranks = np.minimum(rng.zipf(a, rows * per_row) - 1, cols - 1)
    c = rng.permutation(cols)[ranks]
    return _coo(np.repeat(np.arange(rows), per_row), c, (rows, cols), rng)


def _hybrid_pair(a):
    from ..formats.plan import _auto_sell_plan, _try_dia_plan

    return {"hybrid": _try_dia_plan(a, min_diag_fill=0.5,
                                    min_dia_coverage=0.3, **_KW),
            "sell": _auto_sell_plan(a, **_KW)}


def _coo_pair(a):
    from ..formats.cached import coo_tail_from_csr
    from ..formats.plan import _auto_sell_plan

    return {"coo": coo_tail_from_csr(a), "sell": _auto_sell_plan(a, **_KW)}


def _chunk_pair(a):
    from ..formats.chunk import build_chunk_plan
    from ..formats.plan import _cdiv, build_sell_plan

    lens = np.diff(np.asarray(a.indptr))
    split = max(8, _cdiv(int(max(1.0, lens.mean()) * 4), 8) * 8)
    return {"chunk": build_chunk_plan(a),
            "sell_split_sigma": build_sell_plan(a, sigma=1024, split=split,
                                                **_KW)}


def _cached_pair(a):
    from ..formats.cached import build_cached_plan
    from ..formats.plan import _auto_sell_plan

    return {"cached": build_cached_plan(a, **_KW),
            "sell": _auto_sell_plan(a, allow_cached=False, **_KW)}


def check_cases(scale: float = 1.0):
    """(name, matrix maker, candidate builder, margin): each routing
    test's matrix shape, then full-size matrices of the same classes.
    Each builder returns the challenger first and the SELL plan second;
    ``auto_plan`` takes the challenger when it prices below ``margin``
    times the SELL plan.  ``scale`` shrinks the full-size matrices (a CPU
    rehearsal)."""
    from .realistic import banded, webbase_like

    def big(n):
        return max(1024, int(n * scale))

    def banded_noisy():
        # bench.py's 27-diagonal band plus one random entry per row
        from ..formats.convert import from_scipy
        import scipy.sparse as sp

        n = big(1 << 20)
        m = banded(n)
        rng = np.random.default_rng(5)
        noise = sp.csr_matrix((np.ones(n, np.float32),
                               (np.arange(n), rng.integers(0, n, n))),
                              shape=(n, n))
        m = (m + noise).tocsr()
        m.sort_indices()
        return from_scipy(m.astype(np.float32))

    return [
        ("test_hybrid_1k", lambda: banded_plus_noise(1024, range(-8, 9),
                                                     300), _hybrid_pair,
         0.7),
        ("test_coo_500", lambda: uniform(500, 0.02), _coo_pair, 1.0),
        ("test_chunk_8k", lambda: pareto_banded(8192, 4096), _chunk_pair,
         1.0),
        ("test_cached_8k_x_64k",
         lambda: powerlaw_cols(8192, 65536, 32), _cached_pair, 1.0),
        ("full_hybrid_1m", banded_noisy, _hybrid_pair, 0.7),
        ("full_chunk_webbase", lambda: webbase_like(scale=7.5 * scale,
                                                    seed=44), _chunk_pair,
         1.0),
        ("full_cached_1m_x_16m",
         lambda: powerlaw_cols(big(1 << 20), big(1 << 24), 16),
         _cached_pair, 1.0),
    ]


def _apply_chain(plan, iters: int):
    """A jitted ``iters``-apply chain taking the plan as an argument: each
    step feeds the normalized product back into x."""
    import jax
    import jax.numpy as jnp

    from ..ops.spmv_exec import spmv_plan

    k = min(plan.shape)

    def step(u, p):
        w = spmv_plan(p, u)[:k]
        w = w / jnp.maximum(jnp.linalg.norm(w), 1e-30)
        return jax.lax.dynamic_update_slice(u, w.astype(u.dtype), (0,))
    return _fori(step, iters)


def check(scale: float = 1.0, trace: bool = True):
    """Yield one record per matrix: each candidate's predicted and
    measured seconds per apply, and which one each ranks first."""
    import jax
    import jax.numpy as jnp

    from ..formats.costmodel import estimate_seconds
    from ..ops.spmv_exec import spmv_plan
    from ..ops.reference import spmv_numpy

    for name, make, pair, margin in check_cases(scale):
        t0 = time.perf_counter()
        a = make()
        plans = pair(a)
        rec = {"matrix": name, "shape": list(a.shape), "nnz": int(a.nnz),
               "build_s": time.perf_counter() - t0}
        x = np.random.default_rng(1).standard_normal(a.shape[1]) \
            .astype(np.float32)
        want = spmv_numpy(a, x.astype(np.float64))
        for fam, plan in plans.items():
            if plan is None:
                rec[fam] = None
                continue
            pd = plan.to_device()
            y = np.asarray(spmv_plan(pd, x), np.float64)
            err = float(np.abs(y - want).max() /
                        max(np.abs(want).max(), 1e-30))
            xd = jnp.asarray(x)
            r = {"type": type(plan).__name__,
                 "predicted_us": estimate_seconds(plan) * 1e6,
                 "measured_us": _best_seconds(_apply_chain(pd, 100), xd, pd)
                 / 100 * 1e6, "rel_err": err}
            if trace:
                run = _apply_chain(pd, 20)
                jax.block_until_ready(run(xd, pd))
                t = device_kernels(run, xd, pd, steps=20)
                r.update(kernels_per_apply=t["kernels_per_step"],
                         busy_us_per_apply=t["busy_us_per_step"],
                         trace_lines=t["trace_lines"])
            rec[fam] = r
        (c, rc), (d, rd) = ((f, rec[f]) for f in plans)
        if rc and rd:
            rec["model_picks"] = c if rc["predicted_us"] < \
                margin * rd["predicted_us"] else d
            rec["faster"] = c if rc["measured_us"] < rd["measured_us"] \
                else d
            if trace:
                rec["less_busy"] = c if rc["busy_us_per_apply"] < \
                    rd["busy_us_per_apply"] else d
        yield rec


def main(argv=None) -> int:
    import jax

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--check", action="store_true",
                    help="also time both candidates of each routing choice")
    args = ap.parse_args(argv)
    d0 = jax.devices()[0]
    if d0.platform != "gpu":
        raise SystemExit(f"costcal measures the GPU; JAX found "
                         f"{d0.platform!r}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    res = measure()
    res.update({"device_kind": d0.device_kind, "nvidia_smi": smi})
    print(json.dumps(res), flush=True)
    if args.check:
        for rec in check():
            print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
