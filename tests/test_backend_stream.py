"""Streaming bandwidth and executors — the TestSpMVBackend analog.

The reference verifies its DMA engine by streaming known data through the
backend (``chisel/tests/TestSpMVBackend.scala:122-178``); on silicon the
same test reports bytes/cycle (``tests/TestSpMVBackend.cpp:100-102``).
Here the timing helpers behind that report are checked on the CPU (their
arithmetic, not a device rate); the ``on_chip`` tests need the GPU (the
``gpu`` fixture skips them elsewhere): the measured streaming bandwidth
must land in the H200's range, and the compiled executors must agree with
the plain reference.
"""

import time

import numpy as np
import pytest
import scipy.sparse as sp


def test_time_marginal_cancels_fixed_cost():
    """A fake chain with a 5 ms fixed cost and 0.2 ms per step: the
    two-point difference returns the per-step cost alone."""
    from spmv_vector_cache_tpu.utils import roofline

    def make_chain(iters):
        def run():
            time.sleep(5e-3 + iters * 2e-4)
            return np.zeros(1)
        return run

    dt = roofline.time_marginal(make_chain, i1=10, i2=40, repeats=2)
    assert 1.5e-4 < dt < 3e-4, dt


@pytest.mark.parametrize("mode,per_byte", [("read", 1), ("readwrite", 2)])
def test_stream_bandwidth_helper_runs(mode, per_byte, monkeypatch):
    """The bandwidth helper divides the bytes its chain moves by the
    marginal step time (pinned here, so the arithmetic is checked and no
    CPU rate is read as a device rate)."""
    from spmv_vector_cache_tpu.utils import roofline

    seen = []

    def fake_marginal(make, i1, i2):
        seen.append(np.asarray(make(2)()))
        return 1e-3

    monkeypatch.setattr(roofline, "time_marginal", fake_marginal)
    nbytes = 1 << 16
    bw = roofline.measure_stream_bandwidth(nbytes=nbytes, mode=mode)
    assert bw == pytest.approx(per_byte * nbytes / 1e-3)
    assert np.all(np.isfinite(seen[0]))


@pytest.mark.on_chip
def test_measured_bandwidth_sane(gpu):
    from spmv_vector_cache_tpu.utils import roofline

    bw = roofline.measure_stream_bandwidth(nbytes=1 << 30)
    # an H200 streams up to 4.8 TB/s (data sheet); a read stream of a
    # 1 GiB array reaches a large share of that even at a reduced power
    # limit, and can never exceed it
    assert 2.0e12 < bw < 4.8e12, bw


@pytest.mark.on_chip
@pytest.mark.parametrize("kind", ["dia", "sell", "chunk", "coo"])
def test_executors_on_gpu_match_reference(gpu, kind):
    from spmv_vector_cache_tpu.formats.chunk import build_chunk_plan
    from spmv_vector_cache_tpu.formats.convert import from_scipy
    from spmv_vector_cache_tpu.formats.cached import coo_tail_from_csr
    from spmv_vector_cache_tpu.formats.dia import build_dia_plan
    from spmv_vector_cache_tpu.formats.plan import build_sell_plan
    from spmv_vector_cache_tpu.ops.spmv_exec import spmv_plan

    rng = np.random.default_rng(0)
    n = 1 << 16
    if kind == "dia":
        m = sp.spdiags(rng.standard_normal((5, n)), [-300, -1, 0, 1, 300],
                       n, n).tocsr()
    else:
        lens = np.minimum(rng.zipf(1.8, n), 2000)
        r = np.repeat(np.arange(n), lens)
        c = np.clip(r + rng.integers(-500, 500, r.shape[0]), 0, n - 1)
        m = sp.csr_matrix((rng.standard_normal(r.shape[0]), (r, c)),
                          shape=(n, n))
        m.sum_duplicates()
    m.sort_indices()
    a = from_scipy(m.astype(np.float32))
    build = {"dia": build_dia_plan,
             "sell": lambda a: build_sell_plan(a, split=32, sigma=1024),
             "chunk": build_chunk_plan,
             "coo": coo_tail_from_csr}[kind]
    plan = build(a).to_device()
    x = rng.standard_normal(n).astype(np.float32)
    y = np.asarray(spmv_plan(plan, x))
    want = m.astype(np.float64) @ x.astype(np.float64)
    # f32 sums in an order that differs from the host's (and, for the
    # scatter epilogues, from run to run): relative to the largest entry
    err = np.abs(y - want).max() / np.abs(want).max()
    assert err < 1e-5, err
