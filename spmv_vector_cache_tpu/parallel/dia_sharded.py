"""Multi-device DIA SpMV: row-partitioned diagonal plans with ppermute halos.

The banded structure that makes the single-device DIA executor gather-free
(:mod:`..ops.spmv_dia`) also makes its multi-device exchange minimal: a row
block [d*rps, (d+1)*rps) only needs x entries within the diagonal span of
its own rows, so each device fetches one left and one right **halo** of
``halo = round128(max(|offsets|))`` entries from its ring neighbors via
``ppermute`` — O(band) bytes over the device links instead of the O(n)
all-gather the general SELL path uses (``spmv_sharded.py``).  This is the distributed
version of the reference's central question — how much of the
irregularly-accessed vector must be resident — answered per device.

Ring wraparound at the edge shards delivers the other end's values into
the halo, but every value slot referencing out-of-matrix columns is zero
by construction, so the wrapped garbage multiplies to zero (the same
padding discipline the single-device executors rely on).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..formats.dia import DIA, csr_to_dia
from ..formats.plan import _as_csr
from ..ops.spmv_dia import dia_sum
from ..utils import platform

Array = Any


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class ShardedDiaPlan:
    """D-shard stack of DIA tile plans (uniform shapes for SPMD).

    ``vals``: (num_shards, T, D, S, 128); offsets are shared static aux
    (all shards run the same diagonal slices — one compiled program).
    ``halo``: per-side x halo width (multiple of 128, >= max |offset|).
    """

    vals: Array
    offsets: Tuple[int, ...]
    shape: Tuple[int, int]
    num_shards: int
    rows_per_shard: int
    sublanes: int
    halo: int

    def tree_flatten(self):
        return (self.vals,), (self.offsets, self.shape, self.num_shards,
                              self.rows_per_shard, self.sublanes, self.halo)

    @classmethod
    def tree_unflatten(cls, aux, children):
        offsets, shape, num_shards, rps, sublanes, halo = aux
        return cls(vals=children[0], offsets=offsets, shape=shape,
                   num_shards=num_shards, rows_per_shard=rps,
                   sublanes=sublanes, halo=halo)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def build_sharded_dia_plan(a, num_shards: int, *, sublanes: int = 64,
                           value_dtype=np.float32) -> ShardedDiaPlan:
    """Partition rows into ``num_shards`` blocks, one DIA plan each.

    Requires a square matrix (row-partitioned x) whose diagonal span fits
    one shard (``halo <= rows_per_shard``)."""
    if not isinstance(a, DIA):
        a = csr_to_dia(_as_csr(a))
    rows, cols = a.shape
    if rows != cols:
        raise ValueError("sharded DIA requires a square matrix "
                         "(x is row-partitioned like y)")
    offsets = tuple(int(o) for o in np.asarray(a.offsets))
    span = max((abs(o) for o in offsets), default=0)
    halo = _round_up(span, 128) if span else 0

    RS = sublanes * 128
    rps = _round_up(_round_up(rows, num_shards) // num_shards, RS)
    if halo > rps:
        raise ValueError(
            f"diagonal span {span} exceeds rows_per_shard {rps}; "
            "use fewer shards or the all-gather SELL path")
    data = np.asarray(a.data)
    T = rps // RS
    D = len(offsets)
    vals = np.zeros((num_shards, T, D, sublanes, 128), value_dtype)
    for d in range(num_shards):
        r0, r1 = min(d * rps, rows), min((d + 1) * rps, rows)
        if r1 > r0:
            block = np.zeros((D, rps), value_dtype)
            block[:, :r1 - r0] = data[:, r0:r1]
            vals[d] = block.reshape(D, T, sublanes, 128).transpose(1, 0, 2, 3)
    return ShardedDiaPlan(vals=vals, offsets=offsets, shape=(rows, cols),
                          num_shards=num_shards, rows_per_shard=rps,
                          sublanes=sublanes, halo=halo)


def spmv_dia_sharded(sp: ShardedDiaPlan, x: Array, mesh: Mesh, *,
                     axis: str = "x") -> Array:
    """Distributed ``y = A @ x``, x and y row-sharded over ``axis``.

    Exchange = two ``ppermute`` halo shifts of ``halo`` entries each —
    O(band) traffic over the device links, independent of the local
    value stream.  Each shard then runs the single-device diagonal
    executor (:func:`..ops.spmv_dia.dia_sum`) on its halo-extended x.
    """
    platform.route()
    Dsh, rps, halo = sp.num_shards, sp.rows_per_shard, sp.halo
    rows = sp.shape[0]
    xp = jnp.zeros(Dsh * rps, sp.vals.dtype).at[:rows].set(
        jnp.asarray(x, sp.vals.dtype))
    # local column c of a shard lives at x_ext[halo + c]
    starts = [halo + o for o in sp.offsets]

    def local_fn(vals, x_shard):
        vals = vals[0]
        x_shard = x_shard.reshape(-1)
        if halo:
            left = jax.lax.ppermute(
                x_shard[-halo:], axis,
                [(i, (i + 1) % Dsh) for i in range(Dsh)])
            right = jax.lax.ppermute(
                x_shard[:halo], axis,
                [(i, (i - 1) % Dsh) for i in range(Dsh)])
            x_ext = jnp.concatenate([left, x_shard, right])
        else:
            x_ext = x_shard
        return dia_sum(vals, x_ext, starts)[None, :]

    fn = jax.shard_map(local_fn, mesh=mesh,
                       in_specs=(P(axis), P(axis)), out_specs=P(axis))
    y = fn(sp.vals, xp.reshape(Dsh, rps))
    return y.reshape(-1)[:rows]
