"""Where the executors run: one route decision for the whole package.

The reference runs one design both in the Chisel C++ emulator and on
silicon (``chisel/Main.scala:73-83``).  Here the same plain-JAX executors
compile for the GPU, which is the target, and run on the CPU backend,
which serves the tests.  Any other backend is an error: no path falls
back silently to a slower executor or to the host.
"""

from __future__ import annotations

from typing import Optional

import jax

#: backends the executors are built for
ROUTES = ("gpu", "cpu")


def route(backend: Optional[str] = None) -> str:
    """``"gpu"`` on a CUDA backend (the compiled executors), ``"cpu"`` on
    the host backend (tests only; the same executors); raise otherwise.

    ``backend`` defaults to ``jax.default_backend()``."""
    b = jax.default_backend() if backend is None else backend
    if b in ("gpu", "cuda"):
        return "gpu"
    if b == "cpu":
        return "cpu"
    raise RuntimeError(
        f"unsupported JAX backend {b!r}: the sparse executors run on an "
        f"NVIDIA GPU (or on the CPU backend for tests)")
