"""DIA format, diagonal split, and the gather-free diagonal executor.

The reference bundles diagonal matrices (dia64-uint64) and selects a
result-vector placement strategy per matrix structure; the DIA plan is
this library's structure-specialized fast path (4 B/nnz, no gather)."""

import numpy as np
import pytest
import scipy.sparse as sp

from spmv_vector_cache_tpu.formats import convert, dia as diamod
from spmv_vector_cache_tpu.formats.plan import SellPlan, auto_plan
from spmv_vector_cache_tpu.ops import reference, spmv_exec
from spmv_vector_cache_tpu.ops.spmv_dia import spmv_dia
from tests.conftest import random_csr


def _banded(rng, n, offs, dtype=np.float32):
    m = sp.spdiags(rng.standard_normal((len(offs), n)).astype(dtype),
                   offs, n, n).tocsr()
    m.sort_indices()
    return m.astype(dtype)


def _want(a, x):
    return reference.spmv_numpy(a, x.astype(np.float64))


def _hybrid(a):
    """The DIA + SELL-residual candidate auto_plan weighs for ``a``."""
    from spmv_vector_cache_tpu.formats.plan import _try_dia_plan

    h = _try_dia_plan(a, value_dtype=np.float32, max_window_blocks=16,
                      lane_rows=128, positions=8, min_diag_fill=0.5,
                      min_dia_coverage=0.3)
    assert isinstance(h, diamod.HybridPlan)
    return h


# ---------------------------------------------------------------------------
# container + conversions
# ---------------------------------------------------------------------------

def test_csr_dia_roundtrip(rng):
    m = _banded(rng, 200, [-3, -1, 0, 2, 7])
    a = convert.from_scipy(m)
    d = diamod.csr_to_dia(a)
    assert d.ndiag == 5 and d.nnz == a.nnz
    back = diamod.dia_to_csr(d)
    np.testing.assert_array_equal(np.asarray(back.indptr),
                                  np.asarray(a.indptr))
    np.testing.assert_array_equal(np.asarray(back.indices),
                                  np.asarray(a.indices))
    np.testing.assert_allclose(np.asarray(back.data), np.asarray(a.data))


def test_from_scipy_dia_matches_csr_conversion(rng):
    m = _banded(rng, 150, [-5, 0, 1])
    d1 = diamod.from_scipy_dia(m.todia())
    d2 = diamod.csr_to_dia(convert.from_scipy(m))
    np.testing.assert_array_equal(np.asarray(d1.offsets),
                                  np.asarray(d2.offsets))
    np.testing.assert_allclose(np.asarray(d1.data), np.asarray(d2.data))


def test_csr_to_dia_rejects_many_diagonals(rng):
    a = random_csr(rng, 300, 300, density=0.2)
    with pytest.raises(ValueError, match="diagonals"):
        diamod.csr_to_dia(a, max_diags=8)


# ---------------------------------------------------------------------------
# diagonal split (hybrid)
# ---------------------------------------------------------------------------

def test_split_diagonal_pure_banded(rng):
    a = convert.from_scipy(_banded(rng, 256, [-1, 0, 1]))
    d, rest, cov = diamod.split_diagonal(a)
    assert rest is None and cov == 1.0
    assert d.ndiag == 3


def test_split_diagonal_hybrid(rng):
    m = _banded(rng, 256, [0]).tolil()
    m[0, :] = 1.0                                  # dense row off-diagonal
    a = convert.from_scipy(m.tocsr().astype(np.float32))
    d, rest, cov = diamod.split_diagonal(a)
    assert d is not None and rest is not None
    assert 0 < cov < 1
    # split preserves the nonzero multiset
    total = d.nnz + rest.nnz
    assert total == a.nnz


def test_split_diagonal_nothing_qualifies(rng):
    a = random_csr(rng, 400, 400, density=0.01)
    d, rest, cov = diamod.split_diagonal(a, min_diag_fill=0.9)
    assert d is None and rest is a and cov == 0.0


# ---------------------------------------------------------------------------
# DIA executor correctness
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("offs", [
    [0],                                   # identity-like
    [-1, 0, 1],                            # tridiagonal
    [-130, -7, 0, 3, 200],                 # offsets crossing 128/1024 bounds
    [-1025, 0, 1300],
])
def test_dia_kernel_matches_reference(rng, offs):
    n = 700
    m = _banded(rng, n, offs)
    a = convert.from_scipy(m)
    p = diamod.build_dia_plan(a, sublanes=8).to_device()
    x = rng.standard_normal(n).astype(np.float32)
    y = np.asarray(spmv_dia(p, x))
    np.testing.assert_allclose(y, _want(a, x), rtol=2e-5, atol=2e-5)


def test_dia_kernel_rectangular(rng):
    rows, cols = 300, 520
    d0 = rng.standard_normal(rows).astype(np.float32)
    d1 = rng.standard_normal(rows).astype(np.float32)
    m = sp.diags([d0, d1], [0, 200], shape=(rows, cols), format="csr")
    a = convert.from_scipy(m.astype(np.float32))
    p = diamod.build_dia_plan(a, sublanes=8).to_device()
    x = rng.standard_normal(cols).astype(np.float32)
    y = np.asarray(spmv_dia(p, x))
    np.testing.assert_allclose(y, _want(a, x), rtol=2e-5, atol=2e-5)


def test_dia_kernel_multi_step(rng):
    """More rows than one grid step covers."""
    n = 3000
    m = _banded(rng, n, [-2, 0, 5])
    a = convert.from_scipy(m)
    p = diamod.build_dia_plan(a, sublanes=8)
    assert p.num_steps > 1
    x = rng.standard_normal(n).astype(np.float32)
    y = np.asarray(spmv_dia(p.to_device(), x))
    np.testing.assert_allclose(y, _want(a, x), rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# auto_plan dispatch + hybrid execution
# ---------------------------------------------------------------------------

def test_auto_plan_prefers_dia_for_banded(rng):
    a = convert.from_scipy(_banded(rng, 1024, [-2, -1, 0, 1, 2]))
    p = auto_plan(a)
    assert isinstance(p, diamod.DiaPlan)
    x = rng.standard_normal(1024).astype(np.float32)
    y = np.asarray(spmv_exec.spmv_plan(p.to_device(), x))
    np.testing.assert_allclose(y, _want(a, x), rtol=2e-5, atol=2e-5)


def test_auto_plan_hybrid_for_banded_plus_noise(rng):
    m = _banded(rng, 1024, list(range(-8, 9))).tolil()
    cols = rng.integers(0, 1024, 300)
    rows = rng.integers(0, 1024, 300)
    for r, c in zip(rows, cols):
        m[int(r), int(c)] = 1.0
    a = convert.from_scipy(m.tocsr().astype(np.float32))
    # at 1K rows the hybrid's extra launches outweigh its 4 B/nnz stream
    # on the GPU cost model (it used to win): the planner keeps the SELL
    # plan, and the hybrid candidate still executes correctly
    p = auto_plan(a)
    assert isinstance(p, SellPlan)
    h = _hybrid(a)
    x = rng.standard_normal(1024).astype(np.float32)
    for plan in (p, h):
        y = np.asarray(spmv_exec.spmv_plan(plan.to_device(), x))
        np.testing.assert_allclose(y, _want(a, x), rtol=2e-5, atol=2e-5)


def test_auto_plan_falls_back_for_random(rng):
    a = random_csr(rng, 500, 500, density=0.02)
    p = auto_plan(a)
    # 5K nonzeros: the COO path streams no padding and prices just below
    # the SELL layout on the GPU cost model (SELL used to win; the two
    # measure level on the GPU at this size, PERF.md)
    from spmv_vector_cache_tpu.formats.cached import CooTail
    assert isinstance(p, CooTail)


def test_auto_plan_dia_disabled(rng):
    a = convert.from_scipy(_banded(rng, 512, [0, 1]))
    p = auto_plan(a, allow_dia=False)
    # must not be a DIA-family plan; at ~1K nnz the cost model may
    # legitimately pick the COO path over SELL (probe_tiny: 2.7 vs 15 us)
    from spmv_vector_cache_tpu.formats.cached import CooTail
    assert isinstance(p, (SellPlan, CooTail))
    assert not isinstance(p, (diamod.DiaPlan, diamod.HybridPlan))


def test_dia_int32_exact(rng):
    """Order-independent exactness through the DIA kernel (the role of the
    reference's dia64-uint64 bundled matrix, matrixutils.py:100-103)."""
    n = 512
    offs = [-1, 0, 1]
    data = rng.integers(1, 10, (3, n)).astype(np.int32)
    m = sp.spdiags(data, offs, n, n).tocsr()
    a = convert.from_scipy(m)
    ai = type(a)(data=np.asarray(a.data).astype(np.int32),
                 indices=a.indices, indptr=a.indptr, shape=a.shape)
    p = diamod.build_dia_plan(ai, sublanes=8, value_dtype=np.int32)
    x = rng.integers(0, 10, n).astype(np.int32)
    y = np.asarray(spmv_dia(p.to_device(), x))
    want = reference.spmv_numpy(ai, x.astype(np.int64))
    np.testing.assert_array_equal(y.astype(np.int64), want)


# ---------------------------------------------------------------------------
# DIA SpMM (multi-RHS)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 8, 20])
def test_dia_spmm_matches_reference(rng, k):
    from spmv_vector_cache_tpu.ops.spmm_dia import spmm_dia
    n = 900
    m = _banded(rng, n, [-130, -1, 0, 3, 200])
    a = convert.from_scipy(m)
    p = diamod.build_dia_plan(a, sublanes=8).to_device()
    b = rng.standard_normal((n, k)).astype(np.float32)
    y = np.asarray(spmm_dia(p, b))
    want = m.astype(np.float64) @ b
    np.testing.assert_allclose(y, want, rtol=2e-5, atol=2e-5)


def test_dia_spmm_rectangular(rng):
    from spmv_vector_cache_tpu.ops.spmm_dia import spmm_dia
    rows, cols = 300, 520
    d0 = rng.standard_normal(rows).astype(np.float32)
    m = sp.diags([d0, d0], [0, 200], shape=(rows, cols), format="csr")
    a = convert.from_scipy(m.astype(np.float32))
    p = diamod.build_dia_plan(a, sublanes=8).to_device()
    b = rng.standard_normal((cols, 5)).astype(np.float32)
    y = np.asarray(spmm_dia(p, b))
    np.testing.assert_allclose(y, m.astype(np.float64) @ b,
                               rtol=2e-5, atol=2e-5)


def test_spmm_plan_dispatch_hybrid(rng):
    from spmv_vector_cache_tpu.ops.spmm_exec import spmm_plan
    m = _banded(rng, 512, list(range(-8, 9))).tolil()
    for r, c in zip(rng.integers(0, 512, 200), rng.integers(0, 512, 200)):
        m[int(r), int(c)] = 1.0
    a = convert.from_scipy(m.tocsr().astype(np.float32))
    p = _hybrid(a)
    b = rng.standard_normal((512, 8)).astype(np.float32)
    y = np.asarray(spmm_plan(p.to_device(), b))
    want = m.tocsr().astype(np.float64) @ b
    np.testing.assert_allclose(y, want, rtol=2e-5, atol=2e-5)


def test_operator_matmat_dia(rng):
    from spmv_vector_cache_tpu.ops.operator import SparseOperator
    m = _banded(rng, 640, [-2, 0, 2])
    a = convert.from_scipy(m)
    op = SparseOperator.from_matrix(a)
    assert op.strategy == "dia"
    b = rng.standard_normal((640, 4)).astype(np.float32)
    y = np.asarray(op @ b)
    np.testing.assert_allclose(y, m.astype(np.float64) @ b,
                               rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# many DIA blocks, offsets reaching across blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("offs", [[0], [-130, -1, 0, 3, 200], [-1025, 0, 1300]])
def test_dia_multi_block_matches_reference(rng, offs):
    n = 3000
    m = _banded(rng, n, offs)
    a = convert.from_scipy(m)
    p = diamod.build_dia_plan(a, sublanes=8).to_device()
    assert p.num_steps >= 2
    x = rng.standard_normal(n).astype(np.float32)
    y = np.asarray(spmv_dia(p, x))
    np.testing.assert_allclose(y, _want(a, x), rtol=2e-5, atol=2e-5)


def test_auto_plan_dia_for_wide_matrix(rng):
    """Banded structure keeps the DIA plan at any matrix width."""
    n = 1 << 21                                      # 8 MB x image > budget
    m = sp.spdiags(np.ones((3, n), np.float32), [-1, 0, 1], n, n).tocsr()
    m.sort_indices()
    p = auto_plan(convert.from_scipy(m.astype(np.float32)))
    assert isinstance(p, diamod.DiaPlan)


def test_dia_bfloat16_mixed_precision(rng):
    """bf16 value stream (2 B/nnz) with f32 x and accumulation."""
    import jax.numpy as jnp
    n = 2000
    m = _banded(rng, n, [-2, -1, 0, 1, 2])
    a = convert.from_scipy(m)
    p = diamod.build_dia_plan(a, sublanes=8,
                              value_dtype=jnp.bfloat16).to_device()
    assert np.dtype(np.asarray(p.vals).dtype).itemsize == 2
    x = rng.standard_normal(n).astype(np.float32)
    y = np.asarray(spmv_dia(p, x))
    assert y.dtype == np.float32
    want = m.astype(np.float64) @ x
    rel = np.abs(y - want).max() / np.abs(want).max()
    assert rel < 2e-2                                  # bf16 value rounding
