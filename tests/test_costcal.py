"""The cost model's gather pricing and the tool that checks its routing
choices against timed plans (``tools/costcal.py``).  The timings it
prints mean something only on the GPU; here the CPU run checks that every
candidate it builds computes the right product and that the choice it
reports follows the planner's rule."""

import numpy as np
import pytest

from spmv_vector_cache_tpu.formats import costmodel
from spmv_vector_cache_tpu.tools import costcal


@pytest.fixture
def small_l2(monkeypatch):
    """A 16 KB L2 (4096 columns), so the arrays stay small."""
    monkeypatch.setattr(costmodel, "L2_BYTES", 16 << 10)
    return 16 << 10


def test_l2_share_while_x_fits(small_l2):
    assert costmodel.l2_share(small_l2) == 1.0
    assert costmodel.l2_share(4096, np.arange(1024)) == 1.0


def test_l2_share_uniform_beyond_l2(small_l2):
    x_bytes = 4 * small_l2
    assert costmodel.l2_share(x_bytes) == pytest.approx(0.25)
    cols = np.arange(x_bytes // 4)           # every column once
    assert costmodel.l2_share(x_bytes, cols) == pytest.approx(0.25)


def test_l2_share_popular_columns_hit(small_l2):
    """Nine in ten gathers on one column of a vector 4x the L2: the hot
    column is served from L2, so over nine in ten gathers cost the L2
    price."""
    n = small_l2                             # 4n bytes: 4x the L2
    cols = np.concatenate([np.zeros(9 * n, np.int64), np.arange(n)])
    share = costmodel.l2_share(4 * n, cols)
    assert 0.9 < share < 1.0
    assert costmodel.gather_ns(4 * n, cols) < costmodel.gather_ns(4 * n)


def test_check_candidates_agree_with_reference():
    recs = list(costcal.check(scale=1 / 256, trace=False))
    assert [r["matrix"] for r in recs] == \
        [c[0] for c in costcal.check_cases()]
    for rec in recs:
        fams = [k for k, v in rec.items() if isinstance(v, dict)]
        assert len(fams) == 2, rec
        for f in fams:
            assert rec[f]["rel_err"] < 1e-5, (rec["matrix"], f)
            assert rec[f]["predicted_us"] > 0
        assert rec["model_picks"] in fams and rec["faster"] in fams


def test_check_model_pick_follows_margin(monkeypatch):
    """The challenger wins only below ``margin`` times the SELL price."""
    prices = {"HybridPlan": 1e-6, "SellPlan": 1.2e-6}

    monkeypatch.setattr(costmodel, "estimate_seconds",
                        lambda plan: prices.get(type(plan).__name__, 1.0))
    case = [c for c in costcal.check_cases() if c[0] == "test_hybrid_1k"]
    monkeypatch.setattr(costcal, "check_cases", lambda scale: case)
    (rec,) = costcal.check(trace=False)
    assert case[0][3] == 0.7 and rec["model_picks"] == "sell"


def test_costcal_refuses_the_cpu():
    with pytest.raises(SystemExit, match="measures the GPU"):
        costcal.main([])
