"""Executors and the route that picks where they run.

Every plan family runs one plain-JAX executor (``ops/spmv_exec.py``,
``ops/spmv_dia.py``, ``ops/spmm_exec.py``); the same code compiles for the
GPU and runs here on the CPU backend.  These tests hold each executor to
the float64 host reference (``ops/reference.spmv_numpy``) across the
layouts, offsets, semirings and shapes the planner can emit, and pin the
planner's routing of the locality-poor classes.
"""

import numpy as np
import pytest
import scipy.sparse as sp

from spmv_vector_cache_tpu.formats.cached import (CachedPlan, CooTail,
                                                  coo_tail_from_csr)
from spmv_vector_cache_tpu.formats.containers import COO
from spmv_vector_cache_tpu.formats.convert import coo_to_csr, from_scipy
from spmv_vector_cache_tpu.formats.dia import build_dia_plan
from spmv_vector_cache_tpu.formats.plan import (SellPlan, auto_plan,
                                                build_sell_plan)
from spmv_vector_cache_tpu.ops import reference
from spmv_vector_cache_tpu.ops.spmm_exec import spmm_plan, spmm_supported
from spmv_vector_cache_tpu.ops.spmv_exec import lane_unpermute, spmv_plan
from spmv_vector_cache_tpu.ops.strategy import (execution_counters,
                                                plan_bytes_per_apply,
                                                select_strategy)
from spmv_vector_cache_tpu.utils import platform


def _csr(m):
    m = sp.csr_matrix(m).astype(np.float32)
    m.sum_duplicates()
    m.sort_indices()
    return from_scipy(m)


def _check(a, plan, rng, tol=1e-5, semiring="plus_times"):
    x = rng.standard_normal(a.shape[1]).astype(np.float32)
    y = np.asarray(spmv_plan(plan.to_device(), x, semiring=semiring))
    want = reference.spmv_numpy(a, x.astype(np.float64))
    # f32 accumulation in another order than the host loop: relative to
    # the largest entry
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(y, want, rtol=0, atol=tol * scale)
    return y


# ---------------------------------------------------------------------------
# the route
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend,want", [("gpu", "gpu"), ("cuda", "gpu"),
                                          ("cpu", "cpu")])
def test_route_names_the_executors(backend, want):
    assert platform.route(backend) == want


@pytest.mark.parametrize("backend", ["tpu", "rocm", "METAL"])
def test_route_refuses_other_platforms(backend):
    with pytest.raises(RuntimeError, match="unsupported JAX backend"):
        platform.route(backend)


def test_route_here_is_the_cpu_backend():
    assert platform.route() == "cpu"


def test_spmv_refuses_unknown_platform(monkeypatch, rng):
    a = _csr(sp.random(64, 64, density=0.1, random_state=1))
    plan = build_sell_plan(a).to_device()
    monkeypatch.setattr(platform.jax, "default_backend", lambda: "tpu")
    with pytest.raises(RuntimeError, match="unsupported JAX backend"):
        spmv_plan(plan, np.ones(64, np.float32))


# ---------------------------------------------------------------------------
# DIA: offsets at the edges of the matrix and of the row blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,offs", [
    ((700, 700), [-699, 0, 699]),                   # corner-to-corner
    ((700, 700), [-129, -128, -127, 127, 128, 129]),  # 128-row boundaries
    ((2100, 2100), [-1024, -1023, 0, 1023, 1024]),  # one row block apart
    ((300, 900), [0, 250, 899 - 299]),              # wide, last column
    ((900, 300), [-899 + 299, -250, 0]),            # tall, last row
])
def test_dia_edge_offsets(rng, shape, offs):
    rows, cols = shape
    diags = [rng.standard_normal(max(rows, cols)) for _ in offs]
    m = sp.diags(diags, offs, shape=shape, format="csr")
    a = _csr(m)
    plan = build_dia_plan(a, sublanes=8)
    assert plan.pad_left >= max(0, -min(offs))
    _check(a, plan, rng)


def test_dia_spmm_rectangular_tall(rng):
    m = sp.diags([rng.standard_normal(400), rng.standard_normal(400)],
                 [0, -150], shape=(400, 260), format="csr")
    a = _csr(m)
    p = build_dia_plan(a, sublanes=8).to_device()
    b = rng.standard_normal((260, 3)).astype(np.float32)
    np.testing.assert_allclose(np.asarray(spmm_plan(p, b)),
                               m.astype(np.float64) @ b, rtol=2e-5,
                               atol=2e-5)


# ---------------------------------------------------------------------------
# SELL: split / sigma / stripes / uniform split / row_map, semirings
# ---------------------------------------------------------------------------

_LAYOUTS = [
    {},
    {"split": 8},
    {"sigma": 256},
    {"split": 8, "sigma": 1024},
    {"stripe_width": 512, "max_window_blocks": 4},
    {"split": 16, "uniform_split": True, "window_group_tiles": 2},
    {"window_group_tiles": 1, "groups_per_step": 4},
]


@pytest.mark.parametrize("layout", _LAYOUTS,
                         ids=lambda d: "-".join(map(str, d.items())) or "plain")
def test_sell_layouts_match_reference(rng, layout):
    lens = np.minimum(rng.zipf(1.7, 900), 60)
    r = np.repeat(np.arange(900), lens)
    c = np.clip(r + rng.integers(-700, 700, r.shape[0]), 0, 1999)
    a = _csr(sp.coo_matrix((rng.standard_normal(r.shape[0]), (r, c)),
                           shape=(900, 2000)))
    plan = build_sell_plan(a, **layout)
    if layout.get("uniform_split"):
        assert plan.stats.group_slice_identity and plan.stats.uniform_parts
    _check(a, plan, rng)


@pytest.mark.parametrize("semiring", ["min_plus", "max_plus", "max_times"])
def test_sell_semirings_with_row_map(rng, semiring):
    s_zero = {"min_plus": np.inf, "max_plus": -np.inf, "max_times": 0.0}
    dense = np.where(rng.random((300, 400)) < 0.05,
                     rng.random((300, 400)) + 0.5, 0.0)
    dense[7, :] = np.where(rng.random(400) < 0.9, 1.25, 0.0)  # long row
    a = _csr(dense)
    plan = build_sell_plan(a, split=8, sigma=512,
                           pad_value=s_zero[semiring])
    assert not plan.identity_map
    x = (rng.random(400) * 2).astype(np.float32)
    y = np.asarray(spmv_plan(plan.to_device(), x, semiring=semiring))
    want = np.asarray(reference.spmv(a.to_device(), x, semiring=semiring))
    finite = np.isfinite(want)
    np.testing.assert_allclose(y[finite], want[finite], rtol=1e-6,
                               atol=1e-6)
    assert np.array_equal(np.isfinite(y), finite)


def test_sell_counters_count_what_the_executor_moves(rng):
    a = _csr(sp.random(2000, 50000, density=0.001, random_state=5))
    plan = build_sell_plan(a, sigma=1024)
    c = execution_counters(plan)
    slots = int(np.prod(plan.vals.shape))
    assert c["gathers"] == slots
    assert c["kernels"] >= 1 and c["scatter_slots"] > 0
    assert plan_bytes_per_apply(plan) >= a.nnz * 8


# ---------------------------------------------------------------------------
# the matrices the packed two-pass plan used to serve: locality-poor,
# wide, dense-row and empty layouts, now all plain gather executors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rows,cols,density", [
    (300, 5000, 0.01),
    (1000, 40000, 0.002),
    (64, 64, 0.5),
    (500, 100000, 0.0005),
    (20000, 9000, 0.001),
    (50, 3000, 0.3),          # rows longer than a 128-lane run
])
def test_locality_poor_auto_plans_match_reference(rng, rows, cols, density):
    a = _csr(sp.random(rows, cols, density=density,
                       random_state=np.random.RandomState(7)))
    plan = auto_plan(a)
    _check(a, plan, rng, tol=1e-4)


def test_empty_matrix_and_empty_tail_rows(rng):
    a = _csr(sp.csr_matrix((100, 200), dtype=np.float32))
    y = np.asarray(spmv_plan(build_sell_plan(a).to_device(),
                             np.ones(200, np.float32)))
    assert np.all(y == 0)
    # rows beyond the last nonzero come out zero, not uninitialized
    b = _csr(sp.csr_matrix((np.ones(3), ([0, 1, 2], [5, 6, 7])),
                           shape=(40000, 1000)))
    y = np.asarray(spmv_plan(auto_plan(b).to_device(),
                             np.ones(1000, np.float32)))
    assert np.all(y[3:] == 0) and np.all(y[:3] == 1)


def test_bf16_values_locality_poor(rng):
    import jax.numpy as jnp

    a = _csr(sp.random(400, 30000, density=0.002,
                       random_state=np.random.RandomState(3)))
    plan = build_sell_plan(a, value_dtype=jnp.bfloat16)
    y = _check(a, plan, rng, tol=2e-2)
    assert y.dtype == np.float32


def _uniform_random(rng, n, per_row, skew=None):
    rows = np.repeat(np.arange(n, dtype=np.int64), per_row)
    if skew is None:
        cols = rng.integers(0, n, rows.shape[0])
    else:
        cols = np.minimum((n * rng.random(rows.shape[0]) ** skew)
                          .astype(np.int64), n - 1)
    return coo_to_csr(COO(data=rng.standard_normal(rows.shape[0])
                          .astype(np.float32),
                          row=rows.astype(np.int32),
                          col=cols.astype(np.int32), shape=(n, n)))


def test_locality_poor_routes_to_plain_sell(rng):
    """Uniform random columns, no skew: the gather executor serves it
    directly (this matrix used to route to the packed two-pass plan)."""
    a = _uniform_random(rng, 1 << 17, 4)
    plan = auto_plan(a)
    assert isinstance(plan, SellPlan)
    assert select_strategy(plan) == "sell"
    _check(a, plan, rng, tol=1e-4)


def test_skewed_columns_with_cached_x_route_to_plain_sell(rng):
    """Skewed column popularity with an x that fits the L2: no cache tier
    can beat the plain gather (this matrix used to route to a CachedPlan
    with a packed cold tail)."""
    a = _uniform_random(rng, 1 << 17, 4, skew=8)
    plan = auto_plan(a)
    assert not isinstance(plan, CachedPlan)
    _check(a, plan, rng, tol=1e-4)


# ---------------------------------------------------------------------------
# the matrices the resident (x-in-VMEM) strategy used to serve: small x,
# no locality
# ---------------------------------------------------------------------------

def _random_lowdeg(rng, nr, nc, deg):
    r = np.repeat(np.arange(nr), deg)
    c = rng.integers(0, nc, nr * deg)
    return _csr(sp.csr_matrix((rng.standard_normal(nr * deg), (r, c)),
                              shape=(nr, nc)))


@pytest.mark.parametrize("nc", [1000, 4096])
def test_small_x_no_locality_matches_reference(rng, nc):
    a = _random_lowdeg(rng, 2048, nc, 8)
    _check(a, auto_plan(a, allow_dia=False), rng)


def test_small_x_no_locality_keeps_plain_layout(rng):
    """A narrow x needs no striping or caching: the plain layout."""
    a = _random_lowdeg(rng, 4096, 128 * 32, 6)
    plan = auto_plan(a, allow_dia=False)
    assert isinstance(plan, SellPlan)
    assert plan.stats.num_stripes == 1 and plan.stats.window_blocks == 0
    _check(a, plan, rng)


def test_small_x_min_plus(rng):
    dense = np.where(rng.random((300, 512)) < 0.05,
                     rng.random((300, 512)) + 0.5, 0.0)
    a = _csr(dense)
    plan = auto_plan(a, allow_dia=False, semiring="min_plus")
    x = (rng.random(512) * 2).astype(np.float32)
    y = np.asarray(spmv_plan(plan.to_device(), x, semiring="min_plus"))
    md = np.where(dense != 0, dense, np.inf)
    want = np.min(md + x[None, :], axis=1)
    mask = ~np.isinf(want)
    assert np.abs((y - want)[mask]).max() < 1e-5


# ---------------------------------------------------------------------------
# chunk plans: heavy rows and the residue of ultra-sparse heavy stretches
# ---------------------------------------------------------------------------

def test_chunk_heavy_rows_with_sparse_residue(rng):
    from spmv_vector_cache_tpu.formats.chunk import build_chunk_plan

    n = 1 << 15
    r = [np.repeat(np.arange(n), 3)]
    c = [np.clip(r[0] + rng.integers(-50, 50, r[0].shape[0]), 0, n - 1)]
    # two heavy rows: one dense stretch, one spread over > 128 blocks
    r.append(np.full(3000, 11))
    c.append(np.arange(3000) + 100)
    r.append(np.full(600, 12))
    c.append(np.arange(600) * 50)
    r, c = np.concatenate(r), np.concatenate(c)
    a = _csr(sp.coo_matrix((rng.standard_normal(r.shape[0]), (r, c)),
                           shape=(n, n)))
    plan = build_chunk_plan(a)
    assert plan.num_heavy == 2 and plan.hbuckets
    _check(a, plan, rng)


def test_lane_unpermute_rejects_bad_shapes():
    with pytest.raises(ValueError, match="8k, 128"):
        lane_unpermute(np.zeros((4, 128), np.float32),
                       np.zeros((4, 128), np.int16))


# ---------------------------------------------------------------------------
# SpMM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 8, 33])
def test_sell_spmm_matches_reference(rng, k):
    m = sp.random(700, 500, density=0.02, random_state=9).tocsr()
    a = _csr(m)
    p = build_sell_plan(a, split=8, sigma=256).to_device()
    b = rng.standard_normal((500, k)).astype(np.float32)
    y = np.asarray(spmm_plan(p, b))
    np.testing.assert_allclose(y, m.astype(np.float64) @ b, rtol=2e-5,
                               atol=2e-5)


def test_coo_spmm_matches_reference(rng):
    m = sp.random(300, 200, density=0.03, random_state=4).tocsr()
    a = _csr(m)
    p = coo_tail_from_csr(a)
    assert isinstance(p, CooTail)
    b = rng.standard_normal((200, 4)).astype(np.float32)
    np.testing.assert_allclose(np.asarray(spmm_plan(p.to_device(), b)),
                               m.astype(np.float64) @ b, rtol=2e-5,
                               atol=2e-5)


def test_spmm_families_without_executor(rng):
    from spmv_vector_cache_tpu.formats.chunk import build_chunk_plan
    from spmv_vector_cache_tpu.ops.operator import SparseOperator

    lens = np.where(np.arange(4096) % 97 == 0, 900, 3)
    r = np.repeat(np.arange(4096), lens)
    c = np.clip(r + rng.integers(-400, 400, r.shape[0]), 0, 4095)
    m = sp.coo_matrix((rng.standard_normal(r.shape[0]), (r, c)),
                      shape=(4096, 4096)).tocsr()
    a = _csr(m)
    chunk = build_chunk_plan(a)
    assert not spmm_supported(chunk)
    with pytest.raises(ValueError, match="no SpMM executor"):
        spmm_plan(chunk, np.zeros((4096, 2), np.float32))
    # the operator answers from the reference path instead
    op = SparseOperator(chunk.to_device(), matrix=a)
    b = rng.standard_normal((4096, 2)).astype(np.float32)
    np.testing.assert_allclose(np.asarray(op @ b),
                               m.astype(np.float32).astype(np.float64) @ b,
                               rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# the DIA executor across value layouts and dtypes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,sublanes", [
    (np.float32, 64),
    ("bfloat16", 16),
    (np.int32, 64),        # integer plans: exact sums
    (np.float32, 8),       # 1024-row blocks
    (np.float32, 1),       # one 128-row block per tile
])
def test_dia_value_layouts(rng, dtype, sublanes):
    import jax.numpy as jnp

    from spmv_vector_cache_tpu.ops.spmv_dia import spmv_dia

    n = 3000
    offs = [-70, -1, 0, 1, 70]
    if dtype == np.int32:
        data = rng.integers(-9, 10, (len(offs), n)).astype(np.float64)
        x = rng.integers(-9, 10, n)
    else:
        data = rng.standard_normal((len(offs), n))
        x = rng.standard_normal(n)
    m = sp.spdiags(data, offs, n, n).tocsr()
    vd = jnp.bfloat16 if dtype == "bfloat16" else dtype
    plan = build_dia_plan(_csr(m), sublanes=sublanes, value_dtype=vd)
    assert plan.vals.shape[2] == sublanes
    if dtype == np.int32:
        got = np.asarray(spmv_dia(plan.to_device(), x.astype(np.int32)))
        np.testing.assert_array_equal(got, m.astype(np.int64) @ x)
        return
    vals = np.asarray(np.asarray(m.data, np.float32).astype(vd), np.float64)
    mq = sp.csr_matrix((vals, m.indices, m.indptr), shape=m.shape)
    x = x.astype(np.float32)
    got = np.asarray(spmv_dia(plan.to_device(), x))
    np.testing.assert_allclose(got, mq @ x.astype(np.float64), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("offs,value_dtype", [
    ([-300, -1, 0, 1, 300], np.float32),
    ([-1025, 0, 7, 1300], np.float32),
    ([-2, 0, 2], "bfloat16"),
])
def test_dia_sum_over_padded_x(rng, offs, value_dtype):
    """The fused slice sum the DIA executors share (single device and
    per shard), on x padded for offsets past both ends."""
    import jax.numpy as jnp

    from spmv_vector_cache_tpu.ops.spmv_dia import _padded, dia_sum

    vd = jnp.bfloat16 if value_dtype == "bfloat16" else value_dtype
    n = 5000
    m = sp.spdiags(rng.standard_normal((len(offs), n)), offs, n, n).tocsr()
    plan = build_dia_plan(_csr(m), sublanes=16, value_dtype=vd).to_device()
    T, D, S, R = plan.vals.shape
    x = rng.standard_normal(n).astype(np.float32)
    xp = _padded(plan, x, jnp.float32, T * S * R)
    starts = tuple(plan.pad_left + o for o in plan.offsets)
    got = np.asarray(dia_sum(plan.vals, xp, starts))
    assert got.shape == (T * S * R,) and got.dtype == np.float32
    vals = np.asarray(np.asarray(m.data, np.float32).astype(vd), np.float64)
    mq = sp.csr_matrix((vals, m.indices, m.indptr), shape=m.shape)
    np.testing.assert_allclose(got[:n], mq @ x.astype(np.float64),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got[n:], 0)


def test_spmv_dia_refuses_double_plan(rng):
    from spmv_vector_cache_tpu.ops.spmv_dia import spmv_dia

    m = sp.spdiags(rng.standard_normal((3, 512)), [-1, 0, 1], 512, 512)
    plan = build_dia_plan(_csr(m), value_dtype=np.float64)
    with pytest.raises(ValueError, match="double-float plan"):
        spmv_dia(plan, np.zeros(512))
