"""Semiring-parameterized executors (the reference's generalized
semiring SpMV, SemiringOp.scala:5-154).

The reference swaps hardware operator implementations behind one
(makeAdd, makeMul) interface; here the SELL kernels take a semiring name
and the plan's padding is built with that semiring's zero, so tropical
and boolean algebras run through the same window/stream kernels."""

import numpy as np
import pytest
import scipy.sparse as sp

from spmv_vector_cache_tpu.formats import convert
from spmv_vector_cache_tpu.formats.plan import auto_plan, build_sell_plan
from spmv_vector_cache_tpu.ops import reference, semiring as sr
from spmv_vector_cache_tpu.ops.operator import SparseOperator
from spmv_vector_cache_tpu.ops.spmv_exec import spmv_plan
from tests.conftest import random_csr


def _minplus_want(a, x):
    """Host min-plus relaxation: y[i] = min_j (A[i,j] + x[j]) over stored
    entries (absent = +inf)."""
    rows = a.shape[0]
    indptr = np.asarray(a.indptr)
    indices = np.asarray(a.indices)
    data = np.asarray(a.data, np.float64)
    y = np.full(rows, np.inf)
    for i in range(rows):
        for e in range(indptr[i], indptr[i + 1]):
            y[i] = min(y[i], data[e] + x[indices[e]])
    return y


@pytest.mark.parametrize("layout", [{}, {"sigma": 128}])
def test_min_plus_kernels(rng, layout):
    a = random_csr(rng, 200, 150, density=0.06)
    x = rng.standard_normal(150).astype(np.float32)
    p = build_sell_plan(a, pad_value=np.inf, **layout).to_device()
    y = np.asarray(spmv_plan(p, x, semiring="min_plus"))
    want = _minplus_want(a, x)
    finite = np.isfinite(want)
    np.testing.assert_allclose(y[finite], want[finite], rtol=2e-5, atol=2e-5)
    assert (y[~finite] > 1e30).all()       # empty rows read as unreachable


@pytest.mark.parametrize("split", [8, 16])
def test_min_plus_with_split_sigma(rng, split):
    """Tropical algebra through the split/sigma fixup path."""
    a = random_csr(rng, 300, 200, density=0.05)
    x = rng.standard_normal(200).astype(np.float32)
    p = build_sell_plan(a, split=split, sigma=512,
                        pad_value=np.inf).to_device()
    assert not p.identity_map
    y = np.asarray(spmv_plan(p, x, semiring="min_plus"))
    want = _minplus_want(a, x)
    finite = np.isfinite(want)
    np.testing.assert_allclose(y[finite], want[finite], rtol=2e-5, atol=2e-5)


def test_or_and_reachability(rng):
    """Boolean semiring on the {0,1}-float encoding: one step of
    reachability (frontier expansion) matches the adjacency closure."""
    n = 256
    dense = (rng.random((n, n)) < 0.02).astype(np.float32)
    m = sp.csr_matrix(dense)
    a = convert.from_scipy(m)
    frontier = (rng.random(n) < 0.05).astype(np.float32)
    p = build_sell_plan(a, pad_value=0.0).to_device()
    y = np.asarray(spmv_plan(p, frontier, semiring="or_and"))
    want = ((dense.astype(bool) @ frontier.astype(bool)) > 0)
    np.testing.assert_array_equal(y > 0, want)


def test_max_plus_matches_reference_executor(rng):
    a = random_csr(rng, 150, 150, density=0.08)
    x = rng.standard_normal(150).astype(np.float32)
    p = build_sell_plan(a, pad_value=-np.inf).to_device()
    y = np.asarray(spmv_plan(p, x, semiring="max_plus"))
    want = np.asarray(reference.spmv(a, x, semiring=sr.MAX_PLUS))
    finite = np.isfinite(want)
    np.testing.assert_allclose(y[finite], want[finite], rtol=2e-5, atol=2e-5)


def test_operator_semiring_end_to_end(rng):
    a = random_csr(rng, 180, 180, density=0.06)
    op = SparseOperator.from_matrix(a, semiring="min_plus")
    assert op.semiring == "min_plus"
    assert op.plan.stats.pad_value == np.inf
    x = rng.standard_normal(180).astype(np.float32)
    y = np.asarray(op @ x)
    want = _minplus_want(a, x)
    finite = np.isfinite(want)
    np.testing.assert_allclose(y[finite], want[finite], rtol=2e-5, atol=2e-5)


def test_dia_rejects_non_plus_times(rng):
    offs = [-1, 0, 1]
    m = sp.spdiags(rng.standard_normal((3, 256)).astype(np.float32),
                   offs, 256, 256).tocsr()
    m.sort_indices()
    p = auto_plan(convert.from_scipy(m.astype(np.float32)))
    with pytest.raises(ValueError, match="plus_times"):
        spmv_plan(p.to_device(), np.ones(256, np.float32),
                  semiring="min_plus")


def test_auto_plan_semiring_picks_sell_with_pad(rng):
    from spmv_vector_cache_tpu.formats.plan import SellPlan
    offs = [-1, 0, 1]
    m = sp.spdiags(rng.standard_normal((3, 256)).astype(np.float32),
                   offs, 256, 256).tocsr()
    m.sort_indices()
    p = auto_plan(convert.from_scipy(m.astype(np.float32)),
                  semiring="min_plus")
    assert isinstance(p, SellPlan)
    assert p.stats.pad_value == np.inf
    assert np.isinf(np.asarray(p.vals)).any()     # padding is +inf


def test_max_times_rejects_negative_matrix(rng):
    # max-times is only a semiring on the non-negative domain: padding
    # slots carry its zero (0.0), and mul(0, x) = 0 would out-reduce true
    # all-negative row products.  The plan builder must refuse.
    a = random_csr(rng, 64, 64, density=0.06)
    a.data[0] = -1.0
    with pytest.raises(ValueError, match="non-negative"):
        auto_plan(a, semiring="max_times")


def test_max_times_correct_on_nonnegative_domain(rng):
    a = random_csr(rng, 256, 256, density=0.03)
    a.data[:] = np.abs(a.data)
    x = np.abs(rng.standard_normal(256).astype(np.float32))
    plan = auto_plan(a, semiring="max_times").to_device()
    y = np.asarray(spmv_plan(plan, x, semiring="max_times"))
    # host reference: y[i] = max_j A[i,j] * x[j] over stored entries
    indptr, indices = np.asarray(a.indptr), np.asarray(a.indices)
    data = np.asarray(a.data, np.float64)
    want = np.zeros(256)
    for i in range(256):
        for e in range(indptr[i], indptr[i + 1]):
            want[i] = max(want[i], data[e] * x[indices[e]])
    np.testing.assert_allclose(y, want, rtol=1e-5)
