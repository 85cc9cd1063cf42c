"""SpGEMM: sparse x sparse matrix multiply (CSR x CSR -> CSR).

BASELINE.json config 4.  A two-phase split: a host-side **symbolic phase**
computes C's sparsity pattern and, for every output nonzero, the list of
(A-nz, B-nz) product pairs that feed it; the **numeric phase** is then a
fixed-shape device computation — two flat gathers + one sorted
segment-sum — that can be jitted and re-run for new values on the same
pattern (the dominant use: re-factorizations, graph contractions, AMG
setup reuse).

For one-shot multiplies the host path (scipy-grade counting sort) is
already optimal on CPU; the device path wins when the pattern repeats.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..formats.containers import CSR

Array = Any


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class SpGemmPlan:
    """Symbolic product structure for C = A @ B on fixed patterns.

    ``a_src``/``b_src``: (nflops,) indices into A.data / B.data whose
    pairwise products feed C; ``out_id``: (nflops,) the C-nz each product
    accumulates into (sorted);  ``c_indptr``/``c_indices`` give C's CSR
    skeleton.
    """

    a_src: Array
    b_src: Array
    out_id: Array
    c_indptr: Array
    c_indices: Array
    c_shape: Tuple[int, int]
    c_nnz: int

    _array_fields = ("a_src", "b_src", "out_id", "c_indptr", "c_indices")

    def tree_flatten(self):
        children = tuple(getattr(self, f) for f in self._array_fields)
        return children, (self.c_shape, self.c_nnz)

    @classmethod
    def tree_unflatten(cls, aux, children):
        c_shape, c_nnz = aux
        a_src, b_src, out_id, c_indptr, c_indices = children
        return cls(a_src=a_src, b_src=b_src, out_id=out_id,
                   c_indptr=c_indptr, c_indices=c_indices,
                   c_shape=c_shape, c_nnz=c_nnz)


def spgemm_symbolic(a: CSR, b: CSR) -> SpGemmPlan:
    """Host symbolic phase: expand all products, dedupe into C's pattern."""
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"shape mismatch {a.shape} @ {b.shape}")
    a_indptr = np.asarray(a.indptr, dtype=np.int64)
    a_cols = np.asarray(a.indices, dtype=np.int64)
    b_indptr = np.asarray(b.indptr, dtype=np.int64)
    b_cols = np.asarray(b.indices, dtype=np.int64)

    # per A-nz: number of B-nz in row a_cols[e]
    b_rowlen = np.diff(b_indptr)
    counts = b_rowlen[a_cols]                       # (a_nnz,)
    nflops = int(counts.sum())
    a_src = np.repeat(np.arange(a_cols.shape[0], dtype=np.int64), counts)
    # position within the B row for each product
    within = np.arange(nflops, dtype=np.int64) - \
        np.repeat(np.cumsum(counts) - counts, counts)
    b_src = b_indptr[a_cols[a_src]] + within
    # output coordinate of each product
    a_rows = np.repeat(np.arange(a.shape[0], dtype=np.int64),
                       np.diff(a_indptr))
    out_row = a_rows[a_src]
    out_col = b_cols[b_src]
    key = out_row * b.shape[1] + out_col
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    uniq_mask = np.ones(nflops, dtype=bool)
    if nflops:
        uniq_mask[1:] = key_s[1:] != key_s[:-1]
    out_id_s = np.cumsum(uniq_mask) - 1
    c_nnz = int(out_id_s[-1]) + 1 if nflops else 0

    c_keys = key_s[uniq_mask]
    c_rows = (c_keys // b.shape[1]) if nflops else np.zeros(0, np.int64)
    c_cols = (c_keys % b.shape[1]) if nflops else np.zeros(0, np.int64)
    c_indptr = np.zeros(a.shape[0] + 1, dtype=np.int64)
    np.cumsum(np.bincount(c_rows, minlength=a.shape[0]), out=c_indptr[1:])

    return SpGemmPlan(
        a_src=a_src[order].astype(np.int32),
        b_src=b_src[order].astype(np.int32),
        out_id=out_id_s.astype(np.int32),
        c_indptr=c_indptr.astype(np.int32),
        c_indices=c_cols.astype(np.int32),
        c_shape=(a.shape[0], b.shape[1]), c_nnz=c_nnz)


@jax.jit
def spgemm_numeric(plan: SpGemmPlan, a_data: Array, b_data: Array) -> Array:
    """Device numeric phase: C.data for new values on the fixed pattern."""
    prods = jnp.take(a_data, plan.a_src, axis=0) * \
        jnp.take(b_data, plan.b_src, axis=0)
    return jax.ops.segment_sum(prods, plan.out_id,
                               num_segments=max(plan.c_nnz, 1),
                               indices_are_sorted=True)[:plan.c_nnz]


def spgemm(a: CSR, b: CSR, *, plan: SpGemmPlan | None = None
           ) -> Tuple[CSR, SpGemmPlan]:
    """C = A @ B.  Returns (C, plan); pass ``plan`` back in to reuse the
    symbolic phase on a matching pattern."""
    if plan is None:
        plan = spgemm_symbolic(a, b)
    data = spgemm_numeric(plan, jnp.asarray(a.data), jnp.asarray(b.data))
    c = CSR(data=data, indices=plan.c_indices, indptr=plan.c_indptr,
            shape=plan.c_shape)
    return c, plan


def spgemm_host(a: CSR, b: CSR) -> CSR:
    """One-shot host SpGEMM (scipy-backed) — the CPU reference path."""
    import scipy.sparse as sp

    am = sp.csr_matrix((np.asarray(a.data), np.asarray(a.indices),
                        np.asarray(a.indptr)), shape=a.shape)
    bm = sp.csr_matrix((np.asarray(b.data), np.asarray(b.indices),
                        np.asarray(b.indptr)), shape=b.shape)
    cm = (am @ bm).tocsr()
    cm.sort_indices()
    return CSR(data=cm.data, indices=cm.indices.astype(np.int32),
               indptr=cm.indptr.astype(np.int32), shape=tuple(cm.shape))
