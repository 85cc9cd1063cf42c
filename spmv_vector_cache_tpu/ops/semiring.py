"""Semiring abstraction — what makes the kernels *generalized* SpMV.

The reference parameterizes its datapath over a semiring by passing
``makeAdd`` / ``makeMul`` hardware-operator factories in the accelerator
params (``chisel/spmv-common/spmv-common.scala:33-34``) with combinational,
staged-integer, and blackboxed double-precision FP implementations
(``chisel/frontend/SemiringOp.scala:5-154``).

Here the analog is a pair of traceable functions plus an identity element;
XLA fuses them into the surrounding executor.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import jax.numpy as jnp

Array = Any


@dataclasses.dataclass(frozen=True)
class Semiring:
    """(add, mul, zero) with names for cache keys and stat reporting.

    ``add`` must be associative and commutative over the value dtype;
    ``zero`` is the identity of ``add`` and annihilator of ``mul``.
    """

    name: str
    add: Callable[[Array, Array], Array]
    mul: Callable[[Array, Array], Array]
    zero: float
    #: the algebra is only a semiring on the non-negative reals: its
    #: ``zero`` must annihilate under ``mul`` (zero * x == zero), which for
    #: max-times (zero=0, mul=*) holds only when x >= 0 — a negative
    #: operand would make padding slots contribute 0 > the true max.
    #: Plan builders reject negative matrix values for such semirings;
    #: the x vector must satisfy the same domain restriction (not
    #: checkable on device without a sync — documented contract).
    requires_nonnegative: bool = False

    def segment_reduce(self, values: Array, segment_ids: Array,
                       num_segments: int,
                       indices_are_sorted: bool = False) -> Array:
        """Reduce ``values`` by segment with this semiring's ``add``."""
        import jax

        if self.name == "plus_times":
            return jax.ops.segment_sum(values, segment_ids,
                                       num_segments=num_segments,
                                       indices_are_sorted=indices_are_sorted)
        if self.name == "max_times" or self.name == "max_plus":
            return jax.ops.segment_max(values, segment_ids,
                                       num_segments=num_segments,
                                       indices_are_sorted=indices_are_sorted)
        if self.name == "min_plus":
            return jax.ops.segment_min(values, segment_ids,
                                       num_segments=num_segments,
                                       indices_are_sorted=indices_are_sorted)
        if self.name == "or_and":
            # clamp before the cast back: empty segments fill with int32 min,
            # which must read as False, not truthy
            m = jax.ops.segment_max(values.astype(jnp.int32), segment_ids,
                                    num_segments=num_segments)
            return (m > 0).astype(values.dtype)
        raise NotImplementedError(f"segment reduce for semiring {self.name}")


def kernel_ops(name: str):
    """(mul, axis_reduce) as float ops for the SELL executors.

    The boolean semiring runs on a {0.0, 1.0} float encoding (and = *,
    or = max), so every semiring lowers to elementwise mul/min/max/add — the
    counterpart of the reference swapping combinational/staged/blackboxed
    operator implementations behind one interface
    (``SemiringOp.scala:5-154``).
    """
    if name == "plus_times":
        return jnp.multiply, (lambda a, axis: jnp.sum(a, axis=axis))
    if name == "min_plus":
        return jnp.add, (lambda a, axis: jnp.min(a, axis=axis))
    if name == "max_plus":
        return jnp.add, (lambda a, axis: jnp.max(a, axis=axis))
    if name in ("max_times", "or_and"):
        return jnp.multiply, (lambda a, axis: jnp.max(a, axis=axis))
    raise NotImplementedError(f"kernel ops for semiring {name}")


PLUS_TIMES = Semiring("plus_times", add=jnp.add, mul=jnp.multiply, zero=0.0)
# tropical semirings: shortest/longest path relaxations (APSP building block)
MIN_PLUS = Semiring("min_plus", add=jnp.minimum, mul=jnp.add, zero=jnp.inf)
MAX_PLUS = Semiring("max_plus", add=jnp.maximum, mul=jnp.add, zero=-jnp.inf)
MAX_TIMES = Semiring("max_times", add=jnp.maximum, mul=jnp.multiply, zero=0.0,
                     requires_nonnegative=True)
# boolean semiring: reachability / graph pattern matching
OR_AND = Semiring("or_and", add=jnp.logical_or, mul=jnp.logical_and, zero=0.0,
                  requires_nonnegative=True)

REGISTRY = {s.name: s for s in
            (PLUS_TIMES, MIN_PLUS, MAX_PLUS, MAX_TIMES, OR_AND)}


def get(name_or_semiring) -> Semiring:
    if isinstance(name_or_semiring, Semiring):
        return name_or_semiring
    return REGISTRY[name_or_semiring]
