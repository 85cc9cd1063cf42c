#!/usr/bin/env python3
"""Smoke run of the sparse library on one NVIDIA GPU, at real sizes.

Drives the library through the entry points a user calls
(``SparseOperator.from_matrix`` -> ``auto_plan`` -> ``spmv_plan``,
``op @ B``, ``models.solvers.cg``) on matrices well beyond the GPU's
50 MB L2, made from a fixed seed, and holds every result to a float64
host reference (scipy or ``ops/reference.py``).  Phases run in order in
one process; the first failure ends the run with a non-zero exit code.

    python chip_smoke.py              # phases 1-9 on one GPU
    python chip_smoke.py --chips 4    # the sharded paths on four GPUs
    python chip_smoke.py --rehearse   # CPU rehearsal at 1/64 size

The last line of a successful GPU run is one JSON object naming the
device; a run that finds no GPU fails before any phase.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
T0 = time.perf_counter()


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - T0:7.1f}s] {msg}", flush=True)


def check(name: str, err: float, tol: float, why: str) -> None:
    """Print one comparison and fail the run if it misses."""
    ok = bool(err <= tol)
    log(f"{name}: max rel err {err:.3e} (tolerance {tol:.0e}: {why}) "
        f"{'ok' if ok else 'FAILED'}")
    if not ok:
        raise SystemExit(f"{name} missed its tolerance")


def rel_err(y, want) -> float:
    """max |y - want| over max |want|: a sum's error scales with its
    largest terms, not with entries that cancel to near zero."""
    y = np.asarray(y, np.float64)
    want = np.asarray(want, np.float64)
    if y.shape != want.shape or not np.all(np.isfinite(y)):
        return float("inf")
    return float(np.abs(y - want).max() / max(np.abs(want).max(), 1e-300))


# ---------------------------------------------------------------------------
# matrices (all from fixed seeds)
# ---------------------------------------------------------------------------

def uniform_random(n: int, per_row: int = 8, seed: int = 2):
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    r = np.repeat(np.arange(n, dtype=np.int64), per_row)
    c = rng.integers(0, n, r.shape[0])
    m = sp.csr_matrix((rng.standard_normal(r.shape[0]).astype(np.float32),
                       (r, c)), shape=(n, n))
    m.sum_duplicates()
    m.sort_indices()
    return m


def spd_banded(n: int, half: int = 13, seed: int = 3):
    """Symmetric, strictly diagonally dominant (so SPD) banded matrix."""
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    upper = sp.spdiags(rng.standard_normal((half, n)), list(range(1, half + 1)),
                       n, n)
    off = (upper + upper.T).tocsr()
    d = 1.5 * np.asarray(abs(off).sum(axis=1)).ravel() + 1.0
    m = (off + sp.diags(d)).tocsr()
    m.sort_indices()
    return m.astype(np.float32)


def banded(n: int, seed: int = 0):
    from spmv_vector_cache_tpu.tools.realistic import banded as gen

    return gen(n, seed=seed)


def block_random(n: int, seed: int = 1):
    from spmv_vector_cache_tpu.tools.realistic import block_random as gen

    return gen(n, seed=seed)


def to_csr(m):
    from spmv_vector_cache_tpu.formats.convert import from_scipy

    return from_scipy(m)


# ---------------------------------------------------------------------------
# single-GPU phases
# ---------------------------------------------------------------------------

def phase_banded(S: float):
    import jax
    import jax.numpy as jnp

    from spmv_vector_cache_tpu.formats.dia import DiaPlan, build_dia_plan
    from spmv_vector_cache_tpu.ops.operator import SparseOperator

    n = int((1 << 20) * S)
    m = banded(n)
    a = to_csr(m)
    op = SparseOperator.from_matrix(a)
    log(f"phase 1: banded {n}x{n}, {m.nnz} nnz -> "
        f"{type(op.plan).__name__} (plan {op.stats['plan_seconds']:.1f}s)")
    assert isinstance(op.plan, DiaPlan), type(op.plan)
    rng = np.random.default_rng(10)
    x = rng.standard_normal(n).astype(np.float32)
    m64 = m.astype(np.float64)
    check("phase 1 op @ x (f32)", rel_err(op @ x, m64 @ x), 1e-5,
          "f32 sums of 27 terms")

    from spmv_vector_cache_tpu.ops.spmv_exec import spmv_plan

    step = jax.jit(spmv_plan)
    xd = jnp.asarray(x)
    log(f"phase 1 SpMV step memory_analysis: "
        f"{step.lower(op.plan, xd).compile().memory_analysis()}")

    @jax.jit
    def power(plan, v):
        def body(_, u):
            w = spmv_plan(plan, u)
            return w / jnp.linalg.norm(w)
        return jax.lax.fori_loop(0, 50, body, v)

    got = np.asarray(jax.block_until_ready(power(op.plan, xd)))
    u = x.astype(np.float64)
    for _ in range(50):
        u = m64 @ u
        u /= np.linalg.norm(u)
    check("phase 1 power iteration (50 jitted steps)", rel_err(got, u),
          1e-4, "f32 rounding over 50 normalized steps")

    pb = build_dia_plan(a, value_dtype=jnp.bfloat16).to_device()
    opb = SparseOperator(pb, matrix=a)
    mb = m64.copy()
    mb.data = np.asarray(np.asarray(m.data, jnp.bfloat16), np.float64)
    check("phase 1 op @ x (bf16 values)", rel_err(opb @ x, mb @ x), 1e-5,
          "f32 accumulation of bf16-rounded values")
    return m, a, op


def phase_block_random(S: float):
    from spmv_vector_cache_tpu.formats.dia import DiaPlan, HybridPlan
    from spmv_vector_cache_tpu.ops.operator import SparseOperator

    n = int((1 << 19) * S)
    m = block_random(n)
    a = to_csr(m)
    op = SparseOperator.from_matrix(a)
    log(f"phase 2: block-random {n}x{n}, {m.nnz} nnz -> "
        f"{type(op.plan).__name__} executor={op.strategy} "
        f"(plan {op.stats['plan_seconds']:.1f}s)")
    assert not isinstance(op.plan, (DiaPlan, HybridPlan))
    x = np.random.default_rng(11).standard_normal(n).astype(np.float32)
    check("phase 2 op @ x (SELL)", rel_err(op @ x, m.astype(np.float64) @ x),
          1e-5, "f32 sums of 27 terms")
    return m, op


def phase_powerlaw(S: float):
    from spmv_vector_cache_tpu.ops.operator import SparseOperator
    from spmv_vector_cache_tpu.tools.realistic import webbase_like

    a = webbase_like(scale=7.5 * S, seed=44)
    op = SparseOperator.from_matrix(a)
    lens = np.diff(np.asarray(a.indptr))
    log(f"phase 3: power-law rows {a.shape[0]}x{a.shape[1]}, {a.nnz} nnz, "
        f"max/mean row {lens.max() / lens.mean():.0f} -> "
        f"{type(op.plan).__name__} executor={op.strategy} "
        f"(plan {op.stats['plan_seconds']:.1f}s)")
    import scipy.sparse as sp

    m = sp.csr_matrix((np.asarray(a.data, np.float64), np.asarray(a.indices),
                       np.asarray(a.indptr)), shape=a.shape)
    x = np.random.default_rng(12).standard_normal(a.shape[1]).astype(
        np.float32)
    check("phase 3 op @ x (skewed rows)", rel_err(op @ x, m @ x), 1e-5,
          "f32 sums; hub rows reach 4700 terms")


def phase_uniform(S: float):
    from spmv_vector_cache_tpu.ops.operator import SparseOperator

    n = int((1 << 22) * S)
    m = uniform_random(n)
    op = SparseOperator.from_matrix(to_csr(m))
    log(f"phase 4: uniform random {n}x{n}, {m.nnz} nnz -> "
        f"{type(op.plan).__name__} executor={op.strategy} "
        f"(plan {op.stats['plan_seconds']:.1f}s)")
    x = np.random.default_rng(13).standard_normal(n).astype(np.float32)
    check("phase 4 op @ x (locality-poor)",
          rel_err(op @ x, m.astype(np.float64) @ x), 1e-5,
          "f32 sums of 8 terms")


def phase_cg(S: float):
    import jax
    import jax.numpy as jnp

    from spmv_vector_cache_tpu.models.solvers import cg
    from spmv_vector_cache_tpu.ops.operator import SparseOperator

    n = int((1 << 20) * S)
    m = spd_banded(n)
    op = SparseOperator.from_matrix(to_csr(m))
    b = np.random.default_rng(14).standard_normal(n).astype(np.float32)
    solve = jax.jit(lambda rhs: cg(op.matvec, rhs, tol=1e-6, maxiter=500))
    res = jax.block_until_ready(solve(jnp.asarray(b)))
    it = int(res.iterations)
    rec = float(res.residual_norm) / float(np.linalg.norm(b))
    log(f"phase 5: CG on SPD banded {n}x{n} ({type(op.plan).__name__}): "
        f"{it} iterations, recursive residual {rec:.3e}")
    assert rec <= 1e-6 and it < 500, (rec, it)
    x = np.asarray(res.x, np.float64)
    b64 = b.astype(np.float64)
    true = np.linalg.norm(b64 - m.astype(np.float64) @ x) / np.linalg.norm(b64)
    check("phase 5 CG true residual (host f64)", true, 2e-6,
          "1e-6 target plus the f32 rounding of x and A x")


def phase_spmm(m1, op1, m2, op2):
    rng = np.random.default_rng(15)
    for name, m, op in (("banded/DIA", m1, op1), ("block-random/SELL", m2,
                                                 op2)):
        b = rng.standard_normal((m.shape[1], 32)).astype(np.float32)
        y = op @ b
        check(f"phase 6 op @ B k=32 ({name})",
              rel_err(y, m.astype(np.float64) @ b), 1e-5,
              "f32 sums of 27 terms per column")


def phase_df64(m, a):
    from spmv_vector_cache_tpu.ops.operator import SparseOperator

    op = SparseOperator.from_matrix(a, value_dtype=np.float64)
    x = np.random.default_rng(16).standard_normal(m.shape[1])
    y = np.asarray(op @ x, np.float64)
    m64 = m.astype(np.float64)
    want = m64 @ x
    # error relative to the sum of magnitudes of each row's terms: the
    # accuracy a float64 datapath delivers whatever the cancellation
    mag = abs(m64) @ np.abs(x)
    err = float(np.max(np.abs(y - want) / np.maximum(mag, 1e-300)))
    log(f"phase 7: df64 plan {type(op.plan).__name__} "
        f"(double={getattr(op.plan, 'double', None)})")
    check("phase 7 op @ x (df64 vs float64)", err, 1e-11,
          "tests/test_df64.py's rtol, ~2^-48 per operation")


def phase_min_plus(S: float):
    import scipy.sparse as sp

    from spmv_vector_cache_tpu.ops.operator import SparseOperator

    n = int((1 << 20) * S)
    rng = np.random.default_rng(17)
    r = np.repeat(np.arange(n, dtype=np.int64), 8)
    c = np.clip(r + rng.integers(-5000, 5000, r.shape[0]), 0, n - 1)
    m = sp.csr_matrix(((rng.random(r.shape[0]) + 0.1).astype(np.float32),
                       (r, c)), shape=(n, n))
    m.sum_duplicates()
    m.sort_indices()
    op = SparseOperator.from_matrix(to_csr(m), semiring="min_plus")
    x = (rng.random(n) * 10).astype(np.float32)
    y = np.asarray(op @ x, np.float64)
    terms = m.data.astype(np.float64) + x.astype(np.float64)[m.indices]
    want = np.full(n, np.inf)
    nonempty = np.diff(m.indptr) > 0
    want[nonempty] = np.minimum.reduceat(terms, m.indptr[:-1][nonempty])
    log(f"phase 8: min_plus graph {n}x{n}, {m.nnz} edges -> "
        f"{type(op.plan).__name__}")
    check("phase 8 min_plus op @ x", rel_err(y, want), 1e-6,
          "one f32 rounding of w + x")


def phase_on_chip_tests():
    import pytest

    log("phase 9: on_chip tests, in this process")
    rc = pytest.main(["-q", "-m", "on_chip", "-p", "no:cacheprovider",
                      os.path.join(REPO, "tests")])
    log(f"phase 9: pytest exit code {int(rc)}")
    if int(rc) != 0:
        raise SystemExit("on_chip tests failed")


# ---------------------------------------------------------------------------
# four-GPU phase
# ---------------------------------------------------------------------------

def phase_sharded(S: float, ndev: int):
    import jax
    import jax.numpy as jnp

    from spmv_vector_cache_tpu.formats.plan import auto_plan
    from spmv_vector_cache_tpu.ops.spmm_exec import spmm_plan
    from spmv_vector_cache_tpu.ops.spmv_exec import spmv_plan
    from spmv_vector_cache_tpu.parallel import (build_sharded_dia_plan,
                                                build_sharded_plan,
                                                make_mesh, spmm_sharded,
                                                spmv_dia_sharded,
                                                spmv_sharded)

    mesh = make_mesh(ndev)
    rng = np.random.default_rng(20)
    cases = (("banded", banded(int((1 << 22) * S), seed=21)),
             ("block-random", block_random(int((1 << 21) * S), seed=22)))
    for name, m in cases:
        a = to_csr(m)
        n = m.shape[0]
        x = rng.standard_normal(n).astype(np.float32)
        b = rng.standard_normal((n, 8)).astype(np.float32)
        one = auto_plan(a).to_device()             # one-device executor
        y1 = np.asarray(spmv_plan(one, x))
        check(f"4-GPU {name}: one-device SpMV vs host",
              rel_err(y1, m.astype(np.float64) @ x), 1e-5, "f32 sums")
        sp_plan = jax.tree.map(jnp.asarray, build_sharded_plan(a, ndev))
        modes = ["all_gather"] + (["halo"] if 0 < sp_plan.halo
                                  <= sp_plan.rows_per_shard else [])
        for mode in modes:
            f = jax.jit(lambda s, v, mode=mode: spmv_sharded(s, v, mesh,
                                                             mode=mode))
            ys = np.asarray(f(sp_plan, jnp.asarray(x)))
            check(f"4-GPU {name}: spmv_sharded[{mode}] vs one device",
                  rel_err(ys, y1), 1e-5, "same sums, other order")
        ym1 = np.asarray(spmm_plan(auto_plan(a, allow_dia=False)
                                   .to_device(), b))
        yms = np.asarray(jax.jit(lambda s, bb: spmm_sharded(s, bb, mesh))(
            sp_plan, jnp.asarray(b)))
        check(f"4-GPU {name}: spmm_sharded k=8 vs one device",
              rel_err(yms, ym1), 1e-5, "same sums, other order")
        if name == "banded":
            dp = jax.tree.map(jnp.asarray, build_sharded_dia_plan(a, ndev))
            yd = np.asarray(jax.jit(
                lambda s, v: spmv_dia_sharded(s, v, mesh))(dp,
                                                           jnp.asarray(x)))
            check(f"4-GPU {name}: spmv_dia_sharded vs one device",
                  rel_err(yd, y1), 1e-5, "same sums, other order")


# ---------------------------------------------------------------------------

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--chips", type=int, default=1, choices=(1, 4))
    ap.add_argument("--rehearse", action="store_true",
                    help="CPU rehearsal at 1/64 size; prints no result")
    args = ap.parse_args()

    import jax

    devs = jax.devices()
    d0 = devs[0]
    if d0.platform != "gpu" and not args.rehearse:
        print(f"error: JAX found no GPU (platform {d0.platform!r})",
              file=sys.stderr)
        return 2
    from spmv_vector_cache_tpu.utils import platform
    from spmv_vector_cache_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    if not args.rehearse:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60, check=True)
        for line in smi.stdout.strip().splitlines():
            print(line, flush=True)
    log(f"jax {jax.__version__}: {len(devs)} x {d0.device_kind} "
        f"({d0.platform}), route={platform.route()}")
    S = 1 / 64 if args.rehearse else 1.0

    if args.chips == 4:
        if len(devs) < 4:
            raise SystemExit(f"--chips 4 needs 4 devices, found {len(devs)}")
        phase_sharded(S, 4)
    else:
        m1, a1, op1 = phase_banded(S)
        m2, op2 = phase_block_random(S)
        phase_powerlaw(S)
        phase_uniform(S)
        phase_cg(S)
        phase_spmm(m1, op1, m2, op2)
        phase_df64(m1, a1)
        phase_min_plus(S)
        if not args.rehearse:
            phase_on_chip_tests()
    log("all phases passed")
    if args.rehearse:
        return 0
    print(json.dumps({"ok": True, "device": {"platform": d0.platform,
                                             "kind": d0.device_kind,
                                             "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
