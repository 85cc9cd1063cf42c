"""Analyses -> plan selection wiring (VERDICT r3 #7).

The reference's core thesis is that the preprocessing analyses pick the
winning variant (``SparseMatrix.cpp:92-119`` driving buffer strategy).
These tests pin the CSR-dual analyses (column working set = maxAlive,
row spans = maxColSpan) and the decisions they flip."""

import numpy as np
import scipy.sparse as sp

from spmv_vector_cache_tpu.formats import analysis
from spmv_vector_cache_tpu.formats.cached import CachedPlan
from spmv_vector_cache_tpu.formats.containers import COO
from spmv_vector_cache_tpu.formats.convert import coo_to_csr, from_scipy
from spmv_vector_cache_tpu.formats.plan import auto_plan
from spmv_vector_cache_tpu.ops import reference
from spmv_vector_cache_tpu.ops.spmv_exec import spmv_plan


def test_row_spans_and_column_working_set(rng):
    m = sp.csr_matrix(np.array([[1, 0, 0, 2],
                                [0, 3, 0, 0],
                                [0, 0, 0, 0],
                                [4, 0, 5, 6]], np.float32))
    a = from_scipy(m)
    np.testing.assert_array_equal(analysis.row_spans(a), [3, 0, 0, 3])
    # columns 0 and 3 stay live from row 0 to row 3; column 1 opens and
    # closes at one position (net delta 0, matching the reference's
    # same-step +start/-end convention, SparseMatrix.cpp:92-108)
    assert analysis.column_working_set(a) == 2
    s = analysis.summarize(a)
    assert s["maxRowSpan"] == 3 and s["columnWorkingSet"] == 2


def _clustered_cols_matrix(rng, rows=20000, cols=1 << 20, nclusters=8,
                           cluster_w=128, per_cluster=8, clusters_row=2):
    """Rows draw dense runs from a few tight column clusters scattered
    across a huge column space: striping's piece ratio is healthy (>= 4
    nonzeros per stripe piece), but the total working set is tiny."""
    centers = (rng.choice(cols // cluster_w, nclusters, replace=False)
               .astype(np.int64) * cluster_w)
    r = np.repeat(np.arange(rows, dtype=np.int64),
                  clusters_row * per_cluster)
    pick = rng.integers(0, nclusters, (rows, clusters_row))
    offs = rng.integers(0, cluster_w, (rows, clusters_row, per_cluster))
    c = (centers[pick][:, :, None] + offs).reshape(-1)
    return coo_to_csr(COO(
        data=rng.standard_normal(r.shape[0]).astype(np.float32),
        row=r.astype(np.int32), col=c.astype(np.int32),
        shape=(rows, cols)))


def test_working_set_analysis_flips_striping_to_compact_tier(rng):
    """This structure satisfies the striping ratio (>= 4 nnz/piece), and
    the analysis sees a <= 2048 column working set that a full-coverage
    compact tier could serve; the cost model weighs both against the
    plain layout."""
    a = _clustered_cols_matrix(rng)
    ws = analysis.column_working_set(a)
    assert ws <= 2048
    # striping WOULD have been eligible on the ratio alone
    idx = np.asarray(a.indices, dtype=np.int64)
    lens = np.diff(np.asarray(a.indptr))
    nz_row = np.repeat(np.arange(a.shape[0], dtype=np.int64), lens)
    stripe = idx // 2048
    ch = np.ones(idx.shape[0], bool)
    ch[1:] = (nz_row[1:] != nz_row[:-1]) | (stripe[1:] != stripe[:-1])
    assert a.nnz / ch.sum() >= 4.0
    plan = auto_plan(a)
    # an x this narrow stays cache-resident on the GPU, so the cost
    # model keeps the plain layout over both the striped plan and the
    # compact tier (which used to win here)
    from spmv_vector_cache_tpu.formats.plan import SellPlan
    assert isinstance(plan, SellPlan) and plan.stats.num_stripes == 1
    from spmv_vector_cache_tpu.formats.cached import _compact_full_cover
    fc = _compact_full_cover(a, dict(value_dtype=np.float32, lane_rows=128,
                                     positions=8, max_window_blocks=16,
                                     pad_value=0.0))
    assert isinstance(fc, CachedPlan) and fc.coverage == 1.0
    assert fc.cold is None
    x = rng.standard_normal(a.shape[1]).astype(np.float32)
    y = np.asarray(spmv_plan(plan.to_device(), x))
    want = reference.spmv_numpy(a, x.astype(np.float64))
    np.testing.assert_allclose(y, want, rtol=1e-4, atol=1e-4)


def test_span_analysis_narrows_stripe_width(rng):
    """Rows with bounded spans but a large working set stripe at a width
    sized by the span distribution (maxColSpan-dual percentile), not the
    fixed maximum: smaller K per stripe, same piece count."""
    rows, cols = 30000, 1 << 20
    starts = rng.integers(0, cols - 512, rows)
    r = np.repeat(np.arange(rows, dtype=np.int64), 16)
    c = (starts[:, None] + rng.integers(0, 384, (rows, 16))).reshape(-1)
    a = coo_to_csr(COO(
        data=rng.standard_normal(r.shape[0]).astype(np.float32),
        row=r.astype(np.int32), col=c.astype(np.int32),
        shape=(rows, cols)))
    spans = analysis.row_spans(a)
    assert np.percentile(spans[spans > 0], 95) < 512
    plan = auto_plan(a)
    # the cost model vetoes the striped plan this analysis used to
    # force — at 30K scattered 16-nnz rows over 1M columns, stripe-pure
    # slice padding collapses fill to ~3% (streaming 35x the matrix).
    # Whatever the selector emits, it must not be a fill-collapsed SELL
    # layout.
    from spmv_vector_cache_tpu.formats.plan import SellPlan
    if isinstance(plan, SellPlan):
        assert plan.stats.fill >= 0.05
    x = rng.standard_normal(a.shape[1]).astype(np.float32)
    y = np.asarray(spmv_plan(plan.to_device(), x))
    want = reference.spmv_numpy(a, x.astype(np.float64))
    np.testing.assert_allclose(y, want, rtol=1e-4, atol=1e-4)
