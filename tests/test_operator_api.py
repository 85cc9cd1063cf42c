"""SparseOperator API, plan IO, and integer-exactness device path."""

import os

import numpy as np
import pytest

from spmv_vector_cache_tpu.formats import plan_io, refio
from spmv_vector_cache_tpu.formats.plan import auto_plan, build_sell_plan
from spmv_vector_cache_tpu.ops import reference
from spmv_vector_cache_tpu.ops.operator import SparseOperator
from spmv_vector_cache_tpu.ops.spmv_exec import spmv_plan
from tests.conftest import REFERENCE_MATRICES, random_csr, reference_available

needs_reference = pytest.mark.skipif(
    not reference_available(), reason="reference matrices not mounted")


def test_operator_matvec_and_repr(rng):
    a = random_csr(rng, 300, 300, density=0.05)
    op = SparseOperator.from_matrix(a)
    x = rng.standard_normal(300).astype(np.float32)
    y = np.asarray(op @ x)
    want = reference.spmv_numpy(a, x.astype(np.float64))
    np.testing.assert_allclose(y, want, rtol=2e-5, atol=2e-5)
    assert "SparseOperator" in repr(op)
    # 4.5K nonzeros: the COO executor (it used to be a SELL plan; the two
    # price and measure level on the GPU at this size, PERF.md)
    assert op.strategy == "coo"


def test_operator_exec_records_stats(rng):
    a = random_csr(rng, 200, 200, density=0.05)
    op = SparseOperator.from_matrix(a)
    y = op.exec(np.ones(200, np.float32))
    assert "spmvtime" in op.stats.keys()
    assert op.stats["gnnz_per_s"] > 0
    y2 = op.exec(np.ones(200, np.float32), y=np.ones(200, np.float32))
    np.testing.assert_allclose(y2, y + 1.0, rtol=1e-6)


@needs_reference
def test_operator_compare_golden():
    d = os.path.join(REFERENCE_MATRICES, "circuit204")
    a = refio.load_reference_matrix(d)
    gold = refio.load_golden(d)
    op = SparseOperator.from_matrix(a)
    assert op.compare_golden(np.ones(1020, np.float32), gold) == 0
    assert op.stats["diffFromGolden"] == 0
    # corrupt golden must be detected
    bad = gold.copy()
    bad[7] += 1.0
    assert op.compare_golden(np.ones(1020, np.float32), bad) == 1


def test_operator_spmm(rng):
    a = random_csr(rng, 64, 48, density=0.1)
    op = SparseOperator.from_matrix(a)
    b = rng.standard_normal((48, 8)).astype(np.float32)
    y = np.asarray(op @ b)
    from spmv_vector_cache_tpu.formats.convert import to_dense
    np.testing.assert_allclose(y, to_dense(a).astype(np.float64) @ b,
                               rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# plan serialization
# ---------------------------------------------------------------------------

def test_plan_save_load_roundtrip(rng, tmp_path):
    a = random_csr(rng, 400, 300, density=0.04)
    p = build_sell_plan(a, split=8, sigma=512)
    path = str(tmp_path / "plan.npz")
    plan_io.save_plan(p, path)
    q = plan_io.load_plan(path)
    assert q.shape == p.shape and q.stats == p.stats
    assert q.identity_map == p.identity_map
    x = rng.standard_normal(300).astype(np.float32)
    y1 = np.asarray(spmv_plan(p.to_device(), x))
    y2 = np.asarray(spmv_plan(q.to_device(), x))
    np.testing.assert_array_equal(y1, y2)


def test_config_suffix(rng):
    # a 1K-nnz random matrix may route to the COO path by cost; the
    # suffix must still identify it.  Structured suffixes are pinned via
    # an explicit build.
    a = random_csr(rng, 100, 100, density=0.1)
    p = auto_plan(a)
    assert plan_io.config_suffix(p).startswith(
        ("coo", "k", "stream", "dia", "hot", "hybrid"))
    from spmv_vector_cache_tpu.formats.plan import build_sell_plan
    s = plan_io.config_suffix(build_sell_plan(a))
    assert "8x128" in s
    assert s.startswith("k") or s.startswith("stream")


# ---------------------------------------------------------------------------
# integer exactness on the device kernels
# ---------------------------------------------------------------------------

def test_int32_device_kernel_exact(rng):
    """Order-independent exactness: integer matrix through the executor
    (the role of the *-uint64 bundled variants, matrixutils.py:100-103)."""
    a = random_csr(rng, 200, 200, density=0.05)
    ai = type(a)(data=(np.asarray(a.data) != 0).astype(np.int32) *
                 rng.integers(1, 10, a.nnz).astype(np.int32),
                 indices=a.indices, indptr=a.indptr, shape=a.shape)
    p = build_sell_plan(ai, value_dtype=np.int32)
    x = rng.integers(0, 10, 200).astype(np.int32)
    y = np.asarray(spmv_plan(p.to_device(), x))
    want = reference.spmv_numpy(ai, x.astype(np.int64))
    np.testing.assert_array_equal(y.astype(np.int64), want)


def test_operator_audit(rng):
    a = random_csr(rng, 256, 256, density=0.05)
    op = SparseOperator.from_matrix(a)
    out = op.audit(iters=2)
    assert out["gnnz_per_s"] > 0
    assert out["achieved_gb_per_s"] > 0
    assert "seconds" in op.stats.keys()
    # roofline fraction recorded when a peak is supplied
    out2 = op.audit(iters=2, stream_bw=1e12)
    assert 0 < out2["roofline_fraction"] < 1
