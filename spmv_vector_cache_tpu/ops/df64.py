"""Double-float (df64) arithmetic: float64-equivalent precision in f32.

The reference computes SpMV in IEEE double precision end to end (64-bit
``SpMVData``, ``software/SparseMatrix.h:5``; Xilinx DP FP cores,
``chisel/frontend/SemiringOp.scala:98-154``).  The f64-parity plans
compute it as **double-float arithmetic**: every value is an unevaluated
sum ``hi + lo`` of two f32, carrying ~48 bits of significand (vs f64's
53) — error-free transformations (Dekker/Knuth/Veltkamp).  These
primitives are plain ``jnp`` expressions, traced into the executors.

References (public domain algorithms): Dekker 1971 (two_prod, split),
Knuth TAOCP v2 (two_sum), Shewchuk 1997.  XLA preserves IEEE semantics
(no unsafe reassociation), which these transformations rely on.
"""

from __future__ import annotations

from typing import Any, Tuple

import jax.numpy as jnp
import numpy as np

Array = Any

#: Veltkamp split constant for f32: 2^12 + 1 (24-bit significand -> 12+12)
_SPLIT = np.float32(4097.0)


def two_sum(a: Array, b: Array) -> Tuple[Array, Array]:
    """Error-free sum: a + b = s + err exactly (Knuth, 6 flops)."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def quick_two_sum(a: Array, b: Array) -> Tuple[Array, Array]:
    """Error-free sum assuming |a| >= |b| (Dekker, 3 flops)."""
    s = a + b
    return s, b - (s - a)


def veltkamp_split(a: Array) -> Tuple[Array, Array]:
    """a = hi + lo with hi/lo each fitting 12 significand bits."""
    t = _SPLIT * a
    hi = t - (t - a)
    return hi, a - hi


def two_prod(a: Array, b: Array) -> Tuple[Array, Array]:
    """Error-free product: a * b = p + err exactly (Dekker, 17 flops)."""
    p = a * b
    ah, al = veltkamp_split(a)
    bh, bl = veltkamp_split(b)
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, err


def add(xh: Array, xl: Array, yh: Array, yl: Array) -> Tuple[Array, Array]:
    """df64 + df64 (accurate variant: both error terms folded)."""
    sh, se = two_sum(xh, yh)
    te, tf = two_sum(xl, yl)
    se = se + te
    sh, se = quick_two_sum(sh, se)
    se = se + tf
    return quick_two_sum(sh, se)


def mul(xh: Array, xl: Array, yh: Array, yl: Array) -> Tuple[Array, Array]:
    """df64 * df64 (the xl*yl term is below the result's precision)."""
    ph, pe = two_prod(xh, yh)
    pe = pe + (xh * yl + xl * yh)
    return quick_two_sum(ph, pe)


# ---------------------------------------------------------------------------
# host-side f64 <-> (hi, lo) f32 pair conversion
# ---------------------------------------------------------------------------

def split_f64(a) -> Tuple[np.ndarray, np.ndarray]:
    """numpy float64 -> (hi, lo) float32 with a == hi + lo exactly
    (whenever a is representable as such a sum, i.e. |a| in f32 range)."""
    a = np.asarray(a, np.float64)
    hi = a.astype(np.float32)
    lo = (a - hi.astype(np.float64)).astype(np.float32)
    return hi, lo


def join_f64(hi, lo) -> np.ndarray:
    """(hi, lo) f32 pair -> numpy float64 (host-side exact sum)."""
    return np.asarray(hi, np.float64) + np.asarray(lo, np.float64)
