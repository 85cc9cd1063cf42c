"""Plan-parameter autotune (the gen-*.sh design-space-sweep role)."""

import json
import os

import numpy as np
import scipy.sparse as sp

from spmv_vector_cache_tpu.formats.convert import from_scipy
from spmv_vector_cache_tpu.ops import reference
from spmv_vector_cache_tpu.ops.spmv_exec import spmv_plan
from spmv_vector_cache_tpu.ops.tune import (autotune_plan, plan_signature,
                                            _candidates)


def _banded(rng, n=4096, nd=11):
    m = sp.spdiags(rng.standard_normal((nd, n)).astype(np.float32),
                   list(range(-(nd // 2), nd // 2 + 1)), n, n).tocsr()
    m.sort_indices()
    return from_scipy(m.astype(np.float32)), m


def test_signature_stable_and_discriminating(rng):
    a, _ = _banded(rng)
    assert plan_signature(a) == plan_signature(a)
    b, _ = _banded(rng, n=2048)
    assert plan_signature(a) != plan_signature(b)


def test_candidates_cover_plan_types(rng):
    from spmv_vector_cache_tpu.formats.plan import auto_plan

    a, _ = _banded(rng)
    base = auto_plan(a)
    names = [n for n, _, _ in _candidates(a, base, np.float32,
                                          "plus_times")]
    assert "auto" in names and len(names) >= 2
    assert "sell" in names                 # DIA vs SELL
    # a uniform-split SELL plan exposes the split factor
    a27, _ = _banded(rng, nd=27)
    sell = auto_plan(a27, allow_dia=False)
    assert sell.stats.uniform_parts
    names_s = [n for n, _, _ in _candidates(a27, sell, np.float32,
                                            "plus_times")]
    assert any(n.startswith("uniform_split") for n in names_s)


def test_autotune_plan_correct_and_persisted(rng, tmp_path):
    a, m = _banded(rng, n=2048, nd=7)
    store = os.path.join(tmp_path, "tuned.json")
    res = autotune_plan(a, iters=2, store=store)
    assert res.table and res.best in [e.name for e in res.table]
    x = rng.standard_normal(a.shape[1]).astype(np.float32)
    y = np.asarray(spmv_plan(res.plan.to_device(), x))
    want = reference.spmv_numpy(a, x.astype(np.float64))
    np.testing.assert_allclose(y, want, rtol=1e-4, atol=1e-4)
    # persisted: the signature is in the store, and a second call
    # rebuilds the winner without re-timing (single-entry table)
    with open(store) as f:
        data = json.load(f)
    assert res.signature in data
    res2 = autotune_plan(a, iters=2, store=store)
    assert res2.best == res.best
    assert len(res2.table) == 1 and res2.table[0].seconds == 0.0


def test_operator_tune_records_table(rng):
    from spmv_vector_cache_tpu.ops.operator import SparseOperator

    a, m = _banded(rng, n=2048, nd=7)
    op = SparseOperator.from_matrix(a, tune=True)
    keys = op.stats.keys() if hasattr(op.stats, "keys") else []
    assert any(str(k).startswith("tune_") for k in keys)
    x = rng.standard_normal(a.shape[1]).astype(np.float32)
    np.testing.assert_allclose(
        np.asarray(op @ x), reference.spmv_numpy(a, x.astype(np.float64)),
        rtol=1e-4, atol=1e-4)


def test_groups_per_step_rounds_to_fold_multiple(rng):
    """An explicit groups_per_step pads the tile count to a multiple of
    whole window groups."""
    a, m = _banded(rng, n=2048, nd=7)
    from spmv_vector_cache_tpu.formats.plan import build_sell_plan

    p = build_sell_plan(a, groups_per_step=3)
    st = p.stats
    assert st.groups_per_step % st.group_tiles == 0
    assert st.num_tiles % (8 * st.groups_per_step) == 0
    x = rng.standard_normal(a.shape[1]).astype(np.float32)
    y = np.asarray(spmv_plan(p.to_device(), x))
    want = reference.spmv_numpy(a, x.astype(np.float64))
    np.testing.assert_allclose(y, want, rtol=1e-4, atol=1e-4)
