"""Sparse triangular solve + ILU(0) factorization.

BASELINE.json config 4's factorization path.  The device shape of a
triangular solve is **block-sequential, dense-parallel**: rows partition
into 128-wide blocks; the strictly-triangular coupling *between* blocks is
applied as a small dense matvec per step of a ``lax.scan`` over blocks,
and the solve *inside* a block is a dense 128x128 triangular solve — all
dense work with static shapes, no data-dependent control flow (level
scheduling's irregular wavefronts don't map to XLA; fixed block sweeps
do).

The factorization itself (ILU(0)) is inherently sequential preprocessing:
it runs on the host once (numpy Doolittle on the fixed pattern), the
solves run on device every iteration — the same once/many split as the
SpGEMM symbolic phase.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..formats.containers import CSR

HIGHEST = jax.lax.Precision.HIGHEST

Array = Any

BLOCK = 128


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class TriSolvePlan:
    """Blocked dense form of a sparse triangular matrix.

    ``diag_blocks``: (nb, BLOCK, BLOCK) dense diagonal blocks;
    ``off_blocks``: (nb, W, BLOCK, BLOCK) — for block row i, its W nearest
    sub(super)-diagonal block neighbors (banded window; padding zero);
    exact for matrices whose block bandwidth <= W, which the constructor
    verifies.  ``lower`` selects forward vs backward sweep.
    """

    diag_blocks: Array
    off_blocks: Array
    n: int
    lower: bool
    unit_diag: bool

    _array_fields = ("diag_blocks", "off_blocks")

    def tree_flatten(self):
        return ((self.diag_blocks, self.off_blocks),
                (self.n, self.lower, self.unit_diag))

    @classmethod
    def tree_unflatten(cls, aux, children):
        n, lower, unit_diag = aux
        diag_blocks, off_blocks = children
        return cls(diag_blocks=diag_blocks, off_blocks=off_blocks, n=n,
                   lower=lower, unit_diag=unit_diag)

    @property
    def num_blocks(self) -> int:
        return int(self.diag_blocks.shape[0])

    @property
    def width(self) -> int:
        return int(self.off_blocks.shape[1])


def build_trisolve_plan(a: CSR, *, lower: bool, unit_diag: bool = False,
                        value_dtype=np.float32) -> TriSolvePlan:
    """Densify a sparse triangular matrix into the blocked form (host)."""
    n = a.shape[0]
    nb = -(-n // BLOCK)
    np_pad = nb * BLOCK
    indptr = np.asarray(a.indptr, dtype=np.int64)
    cols = np.asarray(a.indices, dtype=np.int64)
    data = np.asarray(a.data).astype(value_dtype)
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))

    bi = rows // BLOCK
    bj = cols // BLOCK
    # block bandwidth (how far off the diagonal block coupling reaches)
    W = int(np.abs(bi - bj).max()) if rows.size else 0
    if W * nb * BLOCK * BLOCK * np.dtype(value_dtype).itemsize > 1 << 31:
        raise ValueError(
            f"block bandwidth {W} too wide to densify ({nb} blocks); "
            "reorder the matrix (RCM) to reduce bandwidth first")

    diag = np.zeros((nb, BLOCK, BLOCK), dtype=value_dtype)
    off = np.zeros((nb, max(W, 1), BLOCK, BLOCK), dtype=value_dtype)
    on_diag = bi == bj
    diag[bi[on_diag], rows[on_diag] % BLOCK, cols[on_diag] % BLOCK] = \
        data[on_diag]
    od = ~on_diag
    dist = np.abs(bi[od] - bj[od]) - 1            # 0-based neighbor slot
    off[bi[od], dist, rows[od] % BLOCK, cols[od] % BLOCK] = data[od]

    if unit_diag:
        diag[:, np.arange(BLOCK), np.arange(BLOCK)] = 1.0
    else:
        # padding rows need a nonsingular diagonal
        if np_pad > n:
            pad_rows = np.arange(n, np_pad)
            diag[pad_rows // BLOCK, pad_rows % BLOCK, pad_rows % BLOCK] = 1.0
        dvals = diag[np.arange(nb)[:, None], np.arange(BLOCK)[None, :],
                     np.arange(BLOCK)[None, :]]
        if np.any(dvals == 0):
            raise ValueError("triangular matrix has zero diagonal entries")

    return TriSolvePlan(diag_blocks=diag, off_blocks=off, n=n, lower=lower,
                        unit_diag=unit_diag)


@jax.jit
def trisolve(plan: TriSolvePlan, b: Array) -> Array:
    """Solve T x = b for blocked triangular T (device, lax.scan sweep)."""
    nb, W = plan.num_blocks, plan.width
    dtype = plan.diag_blocks.dtype
    bp = jnp.zeros(nb * BLOCK, dtype).at[:plan.n].set(
        jnp.asarray(b, dtype))
    bblk = bp.reshape(nb, BLOCK)

    diag = plan.diag_blocks
    off = plan.off_blocks

    # precompute dense inverses of the diagonal blocks (batched)
    tri = jnp.tril(diag) if plan.lower else jnp.triu(diag)
    inv = jnp.linalg.inv(tri)

    order = jnp.arange(nb) if plan.lower else jnp.arange(nb)[::-1]

    def step(carry, bi):
        xs = carry                                  # (nb, BLOCK) solved so far
        rhs = bblk[bi]
        # subtract coupling with the W preceding (following) blocks
        def contrib(w, acc):
            nb_idx = (bi - (w + 1)) if plan.lower else (bi + (w + 1))
            valid = jnp.logical_and(nb_idx >= 0, nb_idx < nb)
            xj = jnp.where(valid, 1.0, 0.0) * xs[jnp.clip(nb_idx, 0, nb - 1)]
            return acc - jnp.dot(off[bi, w], xj, precision=HIGHEST)
        rhs = jax.lax.fori_loop(0, W, contrib, rhs)
        xi = jnp.dot(inv[bi], rhs, precision=HIGHEST)
        xs = xs.at[bi].set(xi)
        return xs, None

    xs0 = jnp.zeros((nb, BLOCK), dtype)
    xs, _ = jax.lax.scan(step, xs0, order)
    return xs.reshape(-1)[:plan.n]


# ---------------------------------------------------------------------------
# ILU(0)
# ---------------------------------------------------------------------------

def _ilu0_values(a: CSR) -> np.ndarray:
    """Factored CSR value array on A's pattern (native C++ when available,
    vectorized-numpy Doolittle otherwise; both require sorted columns)."""
    from .. import native_lib

    if native_lib.available():
        return native_lib.ilu0_inplace(a.indptr, a.indices, a.data)

    n = a.shape[0]
    indptr = np.asarray(a.indptr, dtype=np.int64)
    cols = np.asarray(a.indices, dtype=np.int64)
    data = np.asarray(a.data, dtype=np.float64).copy()

    # diagonal position per row (cols are sorted within each row)
    diag_idx = indptr[:-1] + np.array(
        [np.searchsorted(cols[indptr[i]:indptr[i + 1]], i)
         for i in range(n)], dtype=np.int64)
    bad = (diag_idx >= indptr[1:]) | (cols[np.minimum(
        diag_idx, cols.shape[0] - 1)] != np.arange(n))
    if bad.any():
        raise ValueError(
            f"ILU(0): missing diagonal in row {int(np.flatnonzero(bad)[0])}")

    for i in range(n):
        row_lo, row_hi = indptr[i], indptr[i + 1]
        for e in range(row_lo, diag_idx[i]):
            k = cols[e]
            pivot = data[diag_idx[k]]
            if pivot == 0:
                raise ZeroDivisionError(f"ILU(0): zero pivot at row {k}")
            lik = data[e] / pivot
            data[e] = lik
            # row_i[j] -= lik * row_k[j] on the shared pattern, j > k:
            # vectorized intersect of the two sorted column slices
            f0, f1 = diag_idx[k] + 1, indptr[k + 1]
            if f0 >= f1:
                continue
            tgt = cols[e + 1:row_hi]
            pos = np.searchsorted(tgt, cols[f0:f1])
            ok = pos < tgt.shape[0]
            pos_ok = pos[ok]
            hit = tgt[pos_ok] == cols[f0:f1][ok]
            upd = (e + 1) + pos_ok[hit]
            data[upd] -= lik * data[f0:f1][ok][hit]
    return data


def ilu0(a: CSR) -> Tuple[CSR, CSR]:
    """ILU(0) factorization on the host: A ~= L U with L unit-lower and U
    upper, both on A's sparsity pattern (IKJ Doolittle over CSR).

    Returns (L, U) as CSR.  Use :func:`build_trisolve_plan` +
    :func:`trisolve` for the device-side application
    ``M^{-1} r = U^{-1} (L^{-1} r)`` as a CG/BiCGSTAB preconditioner.
    """
    n = a.shape[0]
    indptr = np.asarray(a.indptr, dtype=np.int64)
    cols = np.asarray(a.indices, dtype=np.int64)
    data = _ilu0_values(a)

    # split into L (unit diag) and U
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    lower_mask = rows > cols
    upper_mask = rows <= cols

    def _make(mask, add_unit_diag):
        r, c, v = rows[mask], cols[mask], data[mask]
        if add_unit_diag:
            r = np.concatenate([r, np.arange(n, dtype=np.int64)])
            c = np.concatenate([c, np.arange(n, dtype=np.int64)])
            v = np.concatenate([v, np.ones(n)])
        order = np.lexsort((c, r))
        r, c, v = r[order], c[order], v[order]
        ip = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(np.bincount(r, minlength=n), out=ip[1:])
        return CSR(data=v, indices=c.astype(np.int32),
                   indptr=ip.astype(np.int32), shape=a.shape)

    return _make(lower_mask, True), _make(upper_mask, False)
