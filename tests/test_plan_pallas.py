"""SELL plans + the SELL gather-reduce executor."""

import os

import numpy as np
import pytest

from spmv_vector_cache_tpu.formats import convert, plan as planmod, refio
from spmv_vector_cache_tpu.formats.containers import COO
from spmv_vector_cache_tpu.formats.convert import coo_to_csr
from spmv_vector_cache_tpu.ops import reference, spmv_exec, strategy
from tests.conftest import REFERENCE_MATRICES, random_csr, reference_available

needs_reference = pytest.mark.skipif(
    not reference_available(), reason="reference matrices not mounted")


def _want(a, x):
    return reference.spmv_numpy(a, x.astype(np.float64))


# ---------------------------------------------------------------------------
# plan construction invariants
# ---------------------------------------------------------------------------

def test_plan_basic_invariants(rng):
    a = random_csr(rng, 300, 200, density=0.05)
    p = planmod.build_sell_plan(a)
    T, P, R = p.vals.shape
    assert (P, R) == (8, 128)
    assert T % planmod.TILES_PER_STEP == 0
    assert p.stats.nnz == a.nnz
    assert p.tile_slice.shape == (T,)
    assert np.all(np.diff(p.tile_slice) >= 0)          # nondecreasing
    assert p.window_base.shape == (T // planmod.WINDOW_GROUP_TILES,)
    assert p.identity_map
    # cols=200 -> window covers everything in 2 blocks
    assert 0 < p.stats.window_blocks <= 2


def test_plan_split_bounds_subrows(rng):
    import scipy.sparse as sp
    dense = np.zeros((64, 64), np.float32)
    dense[0, :] = 1.0
    m = convert.from_scipy(sp.csr_matrix(dense))
    p = planmod.build_sell_plan(m, split=8)
    assert p.stats.num_splits >= 1
    assert not p.identity_map
    assert p.stats.num_subrows > 64


def test_plan_sigma_improves_fill(rng):
    a = random_csr(rng, 2000, 500, density=0.02)
    p0 = planmod.build_sell_plan(a)
    p1 = planmod.build_sell_plan(a, sigma=1024)
    assert p1.stats.fill >= p0.stats.fill


def test_plan_striping_bounds_window(rng):
    a = random_csr(rng, 300, 5000, density=0.02)
    p0 = planmod.build_sell_plan(a, max_window_blocks=4)
    assert p0.stats.window_blocks == 0                 # too wide unstriped
    p1 = planmod.build_sell_plan(a, stripe_width=512, max_window_blocks=4)
    assert 0 < p1.stats.window_blocks <= 4
    assert p1.stats.num_stripes > 1
    assert not p1.identity_map


def test_auto_plan_skewed_splits():
    # one dense row + diagonal, sized above the COO-tail backstop (the
    # r5 cost model routes genuinely tiny matrices to the XLA COO path
    # when the tiled machinery prices out worse; this test pins the
    # *structured* skew response: the dense row must split)
    n = 1 << 17
    cols = 1024
    lens = np.where(np.arange(n) % 100 == 0, cols, 2).astype(np.int64)
    r = np.repeat(np.arange(n, dtype=np.int64), lens)
    rng = np.random.default_rng(0)
    c = rng.integers(0, cols, r.shape[0])
    m = coo_to_csr(COO(data=np.ones(r.shape[0], np.float32),
                       row=r.astype(np.int32), col=c.astype(np.int32),
                       shape=(n, cols)))
    p = planmod.auto_plan(m)
    # the r5 skew response: either the chunk plan (dense rows go heavy,
    # formats/chunk.py) or the split+sigma SELL plan — never the
    # unbounded-slice plain layout
    from spmv_vector_cache_tpu.formats.chunk import ChunkPlan
    if isinstance(p, ChunkPlan):
        assert p.num_heavy >= 1
    else:
        assert p.stats.num_splits >= 1


def test_auto_plan_tiny_cost_backstop():
    # a tiny matrix whose structured plan carries a scatter epilogue is
    # routed to the XLA COO path by the cost model (probe_tiny: 16 ns/nnz
    # with no fixed machinery floor)
    import scipy.sparse as sp
    dense = np.zeros((256, 256), np.float32)
    dense[0, :] = 1.0
    dense[np.arange(256), np.arange(256)] = 1.0
    m = convert.from_scipy(sp.csr_matrix(dense))
    p = planmod.auto_plan(m)
    from spmv_vector_cache_tpu.formats.cached import CooTail
    from spmv_vector_cache_tpu.formats.costmodel import estimate_seconds
    assert isinstance(p, CooTail)
    assert estimate_seconds(p) < 1e-3
    x = np.ones(256, np.float32)
    y = np.asarray(spmv_exec.spmv_plan(p.to_device(), x))
    np.testing.assert_allclose(y, dense @ x, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# executor correctness
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", [{}, {"window_group_tiles": 1}])
def test_kernels_match_reference(rng, layout):
    a = random_csr(rng, 500, 400, density=0.03)
    x = rng.standard_normal(400).astype(np.float32)
    p = planmod.build_sell_plan(a, **layout).to_device()
    y = np.asarray(spmv_exec.spmv_plan(p, x))
    np.testing.assert_allclose(y, _want(a, x), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("layout", [{"split": 8, "sigma": 512},
                                    {"split": 16, "sigma": 128}])
def test_kernels_with_split_sigma(rng, layout):
    a = random_csr(rng, 400, 300, density=0.05)
    x = rng.standard_normal(300).astype(np.float32)
    p = planmod.build_sell_plan(a, **layout).to_device()
    assert not p.identity_map
    y = np.asarray(spmv_exec.spmv_plan(p, x))
    np.testing.assert_allclose(y, _want(a, x), rtol=2e-5, atol=2e-5)


def test_kernel_striped_window(rng):
    a = random_csr(rng, 300, 5000, density=0.02)
    x = rng.standard_normal(5000).astype(np.float32)
    p = planmod.build_sell_plan(a, stripe_width=512,
                                max_window_blocks=4).to_device()
    y = np.asarray(spmv_exec.spmv_plan(p, x))
    np.testing.assert_allclose(y, _want(a, x), rtol=2e-5, atol=2e-5)


def test_kernel_banded_sliding_window(rng):
    import scipy.sparse as sp
    n = 2000
    m = sp.spdiags(rng.standard_normal((5, n)).astype(np.float32),
                   [-2, -1, 0, 1, 2], n, n).tocsr()
    m.sort_indices()
    a = convert.from_scipy(m.astype(np.float32))
    x = rng.standard_normal(n).astype(np.float32)
    # banded matrices auto-plan to DIA now; force the SELL path under test
    p = planmod.auto_plan(a, allow_dia=False)
    assert p.stats.window_blocks > 0                   # banded -> feasible
    assert p.stats.num_stripes == 1                    # no striping needed
    y = np.asarray(spmv_exec.spmv_plan(p.to_device(), x))
    np.testing.assert_allclose(y, _want(a, x), rtol=2e-5, atol=2e-5)


def test_kernel_empty_rows(rng):
    import scipy.sparse as sp
    dense = np.zeros((300, 100), np.float32)
    dense[150:160, :50] = rng.standard_normal((10, 50)).astype(np.float32)
    m = convert.from_scipy(sp.csr_matrix(dense))
    x = rng.standard_normal(100).astype(np.float32)
    p = planmod.build_sell_plan(m).to_device()
    y = np.asarray(spmv_exec.spmv_plan(p, x))
    np.testing.assert_allclose(y, _want(m, x), rtol=2e-5, atol=2e-5)


@needs_reference
@pytest.mark.parametrize("name", ["circuit204", "i64", "i1k", "row64k"])
def test_kernels_vs_golden(name):
    d = os.path.join(REFERENCE_MATRICES, name)
    a = refio.load_reference_matrix(d)
    gold = refio.load_golden(d)
    p = planmod.auto_plan(a).to_device()
    x = np.ones(a.shape[1], dtype=np.float32)
    y = np.asarray(spmv_exec.spmv_plan(p, x))
    np.testing.assert_allclose(y, gold, rtol=1e-4, atol=1e-4)


def test_window_infeasible_plan_executes(rng):
    """A layout with no bounded column window (stats.window_blocks == 0)
    runs through the same gather executor."""
    a = random_csr(rng, 200, 40000, density=0.002)
    p = planmod.build_sell_plan(a, max_window_blocks=2)
    assert p.stats.window_blocks == 0
    x = rng.standard_normal(40000).astype(np.float32)
    y = np.asarray(spmv_exec.spmv_plan(p.to_device(), x))
    np.testing.assert_allclose(y, _want(a, x), rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# executor selection
# ---------------------------------------------------------------------------

def test_select_strategy(rng):
    a = random_csr(rng, 100, 100, density=0.1)
    p = planmod.build_sell_plan(a)
    assert strategy.select_strategy(p) == "sell"
    wide = random_csr(rng, 100, 60000, density=0.001)
    pw = planmod.build_sell_plan(wide, max_window_blocks=2)
    # no window, no special executor: every SELL layout gathers alike
    assert pw.stats.window_blocks == 0
    assert strategy.select_strategy(pw) == "sell"


# ---------------------------------------------------------------------------
# plan validation (debug assertions — SURVEY §5 race-detection analog)
# ---------------------------------------------------------------------------

def test_validate_plan_accepts_all_variants(rng):
    a = random_csr(rng, 300, 400, density=0.04)
    for kwargs in ({}, {"split": 8, "sigma": 512},
                   {"stripe_width": 256, "max_window_blocks": 2}):
        p = planmod.build_sell_plan(a, **kwargs)
        planmod.validate_plan(p, a)


def test_validate_plan_rejects_corruption(rng):
    import dataclasses
    a = random_csr(rng, 200, 200, density=0.05)
    p = planmod.build_sell_plan(a)
    bad = dataclasses.replace(
        p, cols=np.asarray(p.cols).copy() + 10**6)
    with pytest.raises(ValueError, match="column index|window"):
        planmod.validate_plan(bad)
    bad2 = dataclasses.replace(
        p, tile_slice=np.asarray(p.tile_slice)[::-1].copy())
    with pytest.raises(ValueError, match="nondecreasing"):
        planmod.validate_plan(bad2)


def test_unsorted_csr_is_sorted_before_planning(rng):
    """Hand-built CSR with unsorted rows plans correctly (lazy sort)."""
    from spmv_vector_cache_tpu.formats.containers import CSR
    a = random_csr(rng, 200, 200, density=0.05)
    indptr = np.asarray(a.indptr)
    idx = np.asarray(a.indices).copy()
    dat = np.asarray(a.data).copy()
    # reverse each row's entries
    for i in range(200):
        s, e = indptr[i], indptr[i + 1]
        idx[s:e] = idx[s:e][::-1]
        dat[s:e] = dat[s:e][::-1]
    shuffled = CSR(data=dat, indices=idx, indptr=a.indptr, shape=a.shape)
    p = planmod.build_sell_plan(shuffled)
    x = rng.standard_normal(200).astype(np.float32)
    y = np.asarray(spmv_exec.spmv_plan(p.to_device(), x))
    np.testing.assert_allclose(y, _want(a, x), rtol=2e-5, atol=2e-5)


def test_bfloat16_mixed_precision_sell(rng):
    """bf16 value stream in the SELL executor: x and the accumulator stay
    f32 (mirrors the DIA executor's bf16 discipline)."""
    import jax.numpy as jnp

    a = random_csr(rng, 700, 400, density=0.03)
    x = rng.standard_normal(400).astype(np.float32)
    want = _want(a, x)
    p = planmod.build_sell_plan(a, value_dtype=jnp.bfloat16).to_device()
    y = np.asarray(spmv_exec.spmv_plan(p, x))
    assert y.dtype == np.float32                   # f32 accumulation
    rel = np.abs(y - want).max() / max(1.0, np.abs(want).max())
    assert rel < 2e-2                              # bf16 value rounding


# ---------------------------------------------------------------------------
# regression: uniform_split with more parts than lanes (ADVICE r3, high)
# ---------------------------------------------------------------------------

def _long_regular_rows():
    """16 rows x 8192 cols, 3000 nnz/row: regular (std=0, mx<=3*mean) but
    mx/split > lane_rows, which used to ZeroDivision in build_sell_plan."""
    import scipy.sparse as sp
    rows, per_row = 16, 3000
    indices = np.tile(np.arange(per_row, dtype=np.int32), rows)
    indptr = np.arange(rows + 1, dtype=np.int32) * per_row
    data = np.ones(rows * per_row, np.float32)
    return convert.from_scipy(
        sp.csr_matrix((data, indices, indptr), shape=(rows, 8192)))


def test_uniform_split_too_many_parts_raises():
    a = _long_regular_rows()
    with pytest.raises(ValueError, match="uniform_split"):
        planmod.build_sell_plan(a, split=16, uniform_split=True)


def test_auto_plan_long_regular_rows_no_crash():
    a = _long_regular_rows()
    p = planmod.auto_plan(a, allow_dia=False)      # used to ZeroDivision
    assert strategy.plan_nnz(p) == a.nnz
    x = np.ones(a.shape[1], np.float32)
    y = np.asarray(spmv_exec.spmv_plan(p, x))
    np.testing.assert_allclose(y, _want(a, x), rtol=1e-5)
