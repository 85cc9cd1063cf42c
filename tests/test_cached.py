"""CachedPlan (hot/cold column split) + windowless SELL plans — the
locality-poor execution paths (BufferSel / BufferNone analogs)."""

import warnings

import numpy as np
import pytest
import scipy.sparse as sp

from spmv_vector_cache_tpu.formats import plan as planmod
from spmv_vector_cache_tpu.formats.cached import (CachedPlan,
                                                  build_cached_plan,
                                                  column_frequency,
                                                  hot_set_coverage)
from spmv_vector_cache_tpu.formats.convert import from_scipy
from spmv_vector_cache_tpu.ops import reference
from spmv_vector_cache_tpu.ops.spmv_exec import spmv_plan
from spmv_vector_cache_tpu.ops.strategy import (execution_counters,
                                                select_strategy)
from tests.conftest import random_csr


def powerlaw_cols_csr(rng, rows=8192, cols=65536, nnz_row=32, a=1.6):
    """Column-popularity power law, hot columns scattered across the full
    range (zero locality): the webbase-class shape the reference's own
    suite carries (matrices/matrixutils.py:18)."""
    ranks = np.minimum(rng.zipf(a, size=rows * nnz_row) - 1, cols - 1)
    c = rng.permutation(cols)[ranks]
    r = np.repeat(np.arange(rows), nnz_row)
    m = sp.coo_matrix(
        (rng.standard_normal(rows * nnz_row).astype(np.float32), (r, c)),
        shape=(rows, cols)).tocsr()
    m.sum_duplicates()
    m.sort_indices()
    return from_scipy(m.astype(np.float32))


def _want(a, x):
    return reference.spmv_numpy(a, x.astype(np.float64))


def test_column_frequency_and_coverage(rng):
    a = powerlaw_cols_csr(rng)
    counts = column_frequency(a)
    assert counts.sum() == a.nnz
    cov = hot_set_coverage(a)
    assert cov[2048] >= cov[256] >= 0.5        # strong popularity skew
    assert cov[4096] <= 1.0


def test_build_cached_plan_structure(rng):
    a = powerlaw_cols_csr(rng)
    p = build_cached_plan(a)
    assert p is not None
    hc = np.asarray(p.hot_cols)
    assert (np.diff(hc) > 0).all()             # ascending original ids
    assert p.hot.shape == (a.shape[0], hc.shape[0])
    from spmv_vector_cache_tpu.ops.strategy import plan_nnz
    cold_nnz = plan_nnz(p.cold) if p.cold is not None else 0
    assert p.hot.stats.nnz + cold_nnz == a.nnz
    assert abs(p.coverage - p.hot.stats.nnz / a.nnz) < 1e-9
    # the hot part is an ordinary SELL plan over the compact domain
    assert select_strategy(p.hot) == "sell"


def test_auto_plan_picks_cached_and_matches_reference(rng):
    a = powerlaw_cols_csr(rng)
    # a 65K-column x (256 KB) stays in the GPU's L2, so the plain gather
    # beats the hot/cold split (which used to win): the planner keeps the
    # plain layout; the split still executes correctly and counts its
    # hits and misses
    p = planmod.auto_plan(a)
    assert not isinstance(p, CachedPlan)
    c_plan = build_cached_plan(a)
    x = rng.standard_normal(a.shape[1]).astype(np.float32)
    want = _want(a, x)
    for plan in (p, c_plan):
        y = np.asarray(spmv_plan(plan, x))
        np.testing.assert_allclose(y, want, rtol=1e-4, atol=1e-5)
    c = execution_counters(c_plan)
    assert c["hot_hits"] + c["cold_misses"] == a.nnz


def test_cached_plan_no_cold_part(rng):
    # every nonzero in 200 distinct columns of a wide matrix -> the hot
    # set covers 100%, cold is None
    rows, cols = 512, 32768
    hot = rng.choice(cols, 200, replace=False)
    c = hot[rng.integers(0, 200, rows * 8)]
    r = np.repeat(np.arange(rows), 8)
    m = sp.coo_matrix((np.ones(rows * 8, np.float32), (r, c)),
                      shape=(rows, cols)).tocsr()
    m.sum_duplicates()
    a = from_scipy(m.astype(np.float32))
    p = build_cached_plan(a)
    assert p is not None and p.cold is None and p.coverage == 1.0
    x = rng.standard_normal(cols).astype(np.float32)
    np.testing.assert_allclose(np.asarray(spmv_plan(p, x)), _want(a, x),
                               rtol=1e-4, atol=1e-5)


def test_cached_plan_refused_without_skew(rng):
    # uniform column popularity: no working set to cache
    a = random_csr(rng, 400, 65536, density=0.001)
    assert build_cached_plan(a) is None


def test_windowless_sell_matches_reference(rng):
    a = random_csr(rng, 300, 40960, density=0.002)   # 320 blocks, no skew
    p = planmod.build_sell_plan(a)
    assert p.stats.window_blocks == 0
    assert select_strategy(p) == "sell"
    x = rng.standard_normal(a.shape[1]).astype(np.float32)
    y = np.asarray(spmv_plan(p, x))
    np.testing.assert_allclose(y, _want(a, x), rtol=1e-4, atol=1e-5)


def test_very_wide_windowless_executes(rng):
    cols = 2049 * 128                  # wider than any per-block scheme
    a = random_csr(rng, 32, cols, density=0.0004)
    p = planmod.build_sell_plan(a)
    x = rng.standard_normal(cols).astype(np.float32)
    y = np.asarray(spmv_plan(p, x))
    np.testing.assert_allclose(y, _want(a, x), rtol=1e-4, atol=1e-5)


def test_wide_plan_selects_sell_silently(rng):
    cols = 2049 * 128
    a = random_csr(rng, 32, cols, density=0.0004)
    p = planmod.build_sell_plan(a)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        assert select_strategy(p) == "sell"
    assert not w


@pytest.mark.parametrize("semiring", ["min_plus", "or_and"])
def test_cached_semirings(rng, semiring):
    a = powerlaw_cols_csr(rng, rows=16384, cols=32768, nnz_row=32)
    data = np.abs(np.asarray(a.data)) + 0.1
    if semiring == "or_and":
        data = np.ones_like(data)
    from spmv_vector_cache_tpu.formats.containers import CSR
    a = CSR(data=data.astype(np.float32), indices=a.indices,
            indptr=a.indptr, shape=a.shape)
    from spmv_vector_cache_tpu.ops import semiring as sr
    p = build_cached_plan(a, pad_value=sr.get(semiring).zero)
    assert isinstance(p, CachedPlan)
    x = np.abs(rng.standard_normal(a.shape[1])).astype(np.float32)
    if semiring == "or_and":
        x = (x > 0.8).astype(np.float32)
    y = np.asarray(spmv_plan(p, x, semiring=semiring))
    want = np.asarray(reference.spmv(a.to_device(), x, semiring=semiring))
    np.testing.assert_allclose(y, want, rtol=1e-5, atol=1e-5)


def test_operator_cached_integration(rng):
    from spmv_vector_cache_tpu.ops.operator import SparseOperator

    a = powerlaw_cols_csr(rng, rows=16384, cols=32768, nnz_row=32)
    op = SparseOperator(build_cached_plan(a).to_device(), matrix=a)
    assert op.strategy == "cached"
    assert op.stats["strategy_cached"] == 1
    assert 0.0 < op.stats["cache_coverage"] <= 1.0
    x = rng.standard_normal(a.shape[1]).astype(np.float32)
    np.testing.assert_allclose(np.asarray(op @ x), _want(a, x),
                               rtol=1e-4, atol=1e-5)
