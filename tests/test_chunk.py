"""ChunkPlan family: skewed-row layout without the scatter epilogue.

Covers formats/chunk.py and ops/spmv_exec._spmv_chunk: correctness vs
the numpy reference across structure classes, the lane un-permutation in
isolation, bucket SellPlan validity, semirings, duplicates, and the
auto_plan routing.
"""

import numpy as np
import pytest

from spmv_vector_cache_tpu.formats import convert
from spmv_vector_cache_tpu.formats.chunk import (ChunkPlan, SubwinPlan,
                                                 build_chunk_plan)
from spmv_vector_cache_tpu.formats.containers import COO
from spmv_vector_cache_tpu.formats.convert import coo_to_csr
from spmv_vector_cache_tpu.formats.plan import auto_plan, validate_plan
from spmv_vector_cache_tpu.ops import reference
from spmv_vector_cache_tpu.ops.spmv_exec import spmv_plan

RNG = np.random.default_rng(7)


def _pareto_banded(n=4096, seed=0, cap=2048, spread=300):
    rng = np.random.default_rng(seed)
    lens = np.minimum((rng.pareto(1.2, n) * 8).astype(np.int64) + 1, cap)
    r = np.repeat(np.arange(n), lens)
    c = np.clip((np.abs(rng.standard_normal(r.shape[0])) * spread)
                .astype(np.int64) + r - spread // 2, 0, n - 1)
    return coo_to_csr(COO(data=rng.standard_normal(r.shape[0])
                          .astype(np.float32),
                          row=r.astype(np.int32),
                          col=c.astype(np.int32), shape=(n, n)))


def _check(a, plan=None, rtol=1e-5):
    plan = build_chunk_plan(a) if plan is None else plan
    assert plan is not None
    x = RNG.standard_normal(a.shape[1]).astype(np.float32)
    want = reference.spmv_numpy(a, x.astype(np.float64))
    y = np.asarray(spmv_plan(plan, x))
    err = np.abs(y - want).max() / max(1.0, np.abs(np.asarray(want)).max())
    assert err < rtol, err
    return plan


def test_pareto_banded_correct():
    p = _check(_pareto_banded())
    assert isinstance(p, ChunkPlan)
    assert p.num_heavy > 0 and len(p.buckets) >= 1
    assert p.stats.residue_nnz == 0


def test_buckets_are_valid_sellplans():
    p = build_chunk_plan(_pareto_banded())
    for b in p.buckets:
        validate_plan(b)
        # unified segment space: every tile maps into [0, nseg)
        assert b.stats.num_slices == p.num_blocks + p.num_heavy


def test_each_bucket_standalone_matches_reference():
    # a bucket SellPlan is a complete plan: the slow row_map fixup path
    # must agree with the fast chunk epilogue on the summed result
    a = _pareto_banded(n=2048, seed=3, cap=512)
    p = build_chunk_plan(a)
    x = RNG.standard_normal(a.shape[1]).astype(np.float32)
    want = reference.spmv_numpy(a, x.astype(np.float64))
    total = np.zeros(a.shape[0])
    for b in p.buckets:
        total += np.asarray(spmv_plan(b, x),
                            np.float64)
    fast = np.asarray(spmv_plan(p, x))
    hv = fast - total                       # heavy contribution
    assert np.abs(total + hv - want).max() / \
        max(1.0, np.abs(want).max()) < 1e-5


def test_banded_identity_and_tiny():
    n = 600
    r = np.arange(n, dtype=np.int32)
    c = np.maximum(r - 1, 0).astype(np.int32)
    a = coo_to_csr(COO(data=np.ones(n, np.float32), row=r, col=c,
                       shape=(n, n)))
    _check(a)


def test_duplicates_merge():
    r = np.array([0, 0, 0, 1, 1], dtype=np.int32)
    c = np.array([5, 5, 9, 2, 2], dtype=np.int32)
    a = coo_to_csr(COO(data=np.array([1., 2., 3., 4., 5.], np.float32),
                       row=r, col=c, shape=(200, 200)))
    p = build_chunk_plan(a)
    y = np.asarray(spmv_plan(p, np.ones(200, np.float32)))
    assert abs(y[0] - 6) < 1e-5 and abs(y[1] - 9) < 1e-5
    assert p.stats.nnz == 5                  # metric keeps original nnz


def test_heavy_subwin_and_window_fallback():
    # one dense heavy row (subwin W small) + one sparse heavy row
    # (window-packed fallback) + light diagonal
    n = 20000
    rng = np.random.default_rng(5)
    r = np.concatenate([np.zeros(3000), np.full(2000, 7),
                        np.arange(n)]).astype(np.int32)
    c = np.concatenate([
        np.arange(5000, 8000),                       # dense stretch
        np.sort(rng.choice(n, 2000, replace=False)),  # sparse heavy
        np.arange(n)]).astype(np.int32)
    a = coo_to_csr(COO(data=rng.standard_normal(r.shape[0])
                       .astype(np.float32), row=r, col=c, shape=(n, n)))
    p = _check(a)
    assert p.num_heavy == 2
    assert len(p.hbuckets) >= 1
    assert all(isinstance(h, SubwinPlan) for h in p.hbuckets)


def test_ultra_sparse_heavy():
    # heavy row scattered over 3M columns: no subwin tile survives the
    # W cap — the window-packer fallback (kmax windows) must carry it
    rng = np.random.default_rng(9)
    n = 3_000_000
    r = np.concatenate([np.zeros(3000, np.int64), np.arange(500)])
    c = np.concatenate([np.sort(rng.choice(n, 3000, replace=False)),
                        np.arange(500)])
    a = coo_to_csr(COO(data=rng.standard_normal(3500).astype(np.float32),
                       row=r.astype(np.int32), col=c.astype(np.int32),
                       shape=(n, n)))
    p = build_chunk_plan(a)
    x = rng.standard_normal(n).astype(np.float32)
    want = reference.spmv_numpy(a, x.astype(np.float64))
    y = np.asarray(spmv_plan(p, x))
    assert np.abs(y - want).max() / max(1.0, np.abs(want).max()) < 1e-5


def test_empty_rows_and_tail_padding():
    # rows with no nonzeros + rows count not a multiple of 1024
    r = np.array([5, 700, 700, 1500], dtype=np.int32)
    c = np.array([3, 10, 900, 100], dtype=np.int32)
    a = coo_to_csr(COO(data=np.ones(4, np.float32), row=r, col=c,
                       shape=(1543, 1543)))
    _check(a)


def test_semiring_min_plus():
    a = _pareto_banded(n=1024, seed=11, cap=256)
    from spmv_vector_cache_tpu.ops import semiring as sr

    s = sr.get("min_plus")
    p = build_chunk_plan(a, pad_value=float(s.zero),
                         merge_duplicates=False)
    x = RNG.standard_normal(a.shape[1]).astype(np.float32)
    y = np.asarray(spmv_plan(p, x, semiring="min_plus"))
    indptr = np.asarray(a.indptr)
    indices = np.asarray(a.indices)
    data = np.asarray(a.data, np.float64)
    want = np.full(a.shape[0], np.inf)
    for i in range(a.shape[0]):
        for e in range(indptr[i], indptr[i + 1]):
            want[i] = min(want[i], data[e] + x[indices[e]])
    finite = np.isfinite(want)
    np.testing.assert_allclose(y[finite], want[finite], rtol=2e-5,
                               atol=2e-5)
    assert (y[~finite] > 1e30).all()


def test_lane_unpermute_kernel():
    from spmv_vector_cache_tpu.ops.spmv_exec import lane_unpermute

    rng = np.random.default_rng(2)
    S = 16
    y2d = rng.standard_normal((S, 128)).astype(np.float32)
    # a random within-1024-window permutation
    perm = np.arange(S * 128)
    for w0 in range(0, S * 128, 1024):
        perm[w0:w0 + 1024] = w0 + rng.permutation(1024)
    idx = (perm - (np.arange(S * 128) // 1024) * 1024).astype(np.int16)
    out = np.asarray(lane_unpermute(y2d, idx.reshape(S, 128)))
    assert np.array_equal(out.reshape(-1), y2d.reshape(-1)[perm])


def test_auto_plan_routes_powerlaw_to_chunk():
    """The chunk plan is a candidate for skewed rows with bounded spans;
    on the GPU cost model its per-bucket launches and the segment sum over
    every tile lose to the split+sigma SELL plan at this size (it used to
    win), so the planner keeps the SELL plan."""
    from spmv_vector_cache_tpu.formats.costmodel import estimate_seconds
    from spmv_vector_cache_tpu.formats.plan import SellPlan

    a = _pareto_banded(n=8192, seed=13, cap=4096)
    p = auto_plan(a)
    assert isinstance(p, SellPlan) and p.stats.num_splits > 0
    cp = build_chunk_plan(a)
    assert estimate_seconds(p) <= estimate_seconds(cp)


def test_to_device_roundtrip_pytree():
    import jax

    p = build_chunk_plan(_pareto_banded(n=1024, seed=1, cap=256))
    leaves, treedef = jax.tree_util.tree_flatten(p)
    p2 = jax.tree_util.tree_unflatten(treedef, leaves)
    assert p2.shape == p.shape and p2.num_heavy == p.num_heavy
