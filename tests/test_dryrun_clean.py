"""Regression: the 8-device dryrun must compile warning-clean.

An earlier 8-device dryrun emitted "Algebraic simplifier is likely stuck
in a circular simplification loop": gather/select chains feeding the
segment-sum epilogue made XLA's simplifier oscillate.  XLA logs the
message from C++ at ERROR level, so the check runs the dryrun in a
subprocess and greps its stderr.
"""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.slow
def test_dryrun_multichip_no_simplifier_loop():
    env = dict(os.environ)
    env.update({
        "JAX_PLATFORMS": "cpu",
        "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
        "PYTHONPATH": REPO,
    })
    code = (
        "import __graft_entry__ as g; g.dryrun_multichip(8); print('OK')"
    )
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "OK" in proc.stdout
    assert "Algebraic simplifier is likely stuck" not in proc.stderr, \
        proc.stderr[-2000:]
