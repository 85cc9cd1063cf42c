"""Tooling: matrix pipeline, benchmark app, vecdiff."""

import io
import os
import subprocess
import sys

import numpy as np
import pytest

from spmv_vector_cache_tpu.tools import benchapp, matrixtools, vecdiff
from tests.conftest import REFERENCE_MATRICES, reference_available

needs_reference = pytest.mark.skipif(
    not reference_available(), reason="reference matrices not mounted")

MTX = "/root/reference/matrices/mtx/circuit204.mtx"


@needs_reference
def test_matrixtools_reproduces_reference_binaries(tmp_path):
    out = matrixtools.prepare_mtx(MTX, str(tmp_path))
    for part in ("meta", "indptr", "inds", "data"):
        ours = open(os.path.join(out, f"circuit204-{part}.bin"), "rb").read()
        ref = open(os.path.join(REFERENCE_MATRICES, "circuit204",
                                f"circuit204-{part}.bin"), "rb").read()
        assert ours == ref, f"{part} differs from reference output"
    ours_gold = open(os.path.join(out, "golden.bin"), "rb").read()
    ref_gold = open(os.path.join(REFERENCE_MATRICES, "circuit204",
                                 "golden.bin"), "rb").read()
    assert ours_gold == ref_gold


@needs_reference
def test_matrixtools_analyze():
    a = matrixtools.load_mtx(MTX)
    s = matrixtools.analyze(a)
    assert s["nnz"] == 5883 and s["maxAlive"] == 591


def test_matrixtools_uint64_variant(tmp_path):
    a = matrixtools.load_mtx(MTX) if reference_available() else None
    if a is None:
        pytest.skip("no mtx")
    u = matrixtools.to_uint64_matrix(a)
    assert np.asarray(u.data).dtype == np.uint64
    assert (np.asarray(u.data) == 1).all()


def test_matrixtools_suitesparse_offline_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="network download disabled"):
        matrixtools.prepare_suitesparse("Fake/matrix", str(tmp_path))


@needs_reference
def test_benchapp_sweep_csv():
    buf = io.StringIO()
    rc = benchapp.run_sweep(
        [os.path.join(REFERENCE_MATRICES, "i64"),
         os.path.join(REFERENCE_MATRICES, "circuit204")],
        iters=1, out=buf)
    assert rc == 0
    lines = buf.getvalue().strip().splitlines()
    assert lines[0].startswith("matrix,strategy,status")
    assert len(lines) == 3
    header = lines[0].split(",")
    for col in ("diffFromSW", "diffFromGolden", "gnnz_per_s",
                "bytes_per_apply"):
        assert col in header, f"missing CSV column {col}"
    for row in lines[1:]:
        cells = dict(zip(header, row.split(",")))
        assert cells["status"] == "ok"
        assert cells["diffFromSW"] == "0"
        assert cells["diffFromGolden"] == "0"


def test_benchapp_bad_dir():
    buf = io.StringIO()
    rc = benchapp.run_sweep(["/nonexistent"], iters=1, out=buf)
    assert rc == 1


@needs_reference
def test_vecdiff_exact_and_mismatch(tmp_path):
    gold = os.path.join(REFERENCE_MATRICES, "circuit204", "golden.bin")
    buf = io.StringIO()
    assert vecdiff.diff(gold, gold, out=buf) == 0
    assert "identical" in buf.getvalue()
    # perturb one element
    data = np.fromfile(gold, dtype="<f8")
    data[3] += 1e-9
    bad = tmp_path / "bad.bin"
    data.tofile(bad)
    buf = io.StringIO()
    assert vecdiff.diff(gold, str(bad), out=buf) == 1
    assert "1 mismatched" in buf.getvalue()
    # tolerance mode forgives it
    buf = io.StringIO()
    assert vecdiff.diff(gold, str(bad), rtol=1e-6, atol=1e-6, out=buf) == 0


# ---------------------------------------------------------------------------
# chip_smoke.py: refuses a host without a GPU, and rehearses on the CPU
# ---------------------------------------------------------------------------

def _run_chip_smoke(*args, timeout=900):
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, os.path.join(repo,
                                                        "chip_smoke.py"),
                           *args], env=env, cwd=repo, capture_output=True,
                          text=True, timeout=timeout)


def test_chip_smoke_refuses_without_gpu():
    proc = _run_chip_smoke()
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "no GPU" in proc.stderr


def test_chip_smoke_rehearsal_passes_on_cpu():
    proc = _run_chip_smoke("--rehearse")
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "all phases passed" in proc.stdout
    assert '"ok"' not in proc.stdout          # a rehearsal prints no result
