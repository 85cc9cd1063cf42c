"""Reference executors — the ``SoftwareSpMV`` role, twice over.

The reference pins every accelerator variant against a sequential CPU loop,
``y[rowInd[e]] += nzData[e] * x[col]`` over CSC columns
(``software/SoftwareSpMV.cpp:50-70``), itself pinned against scipy goldens
(``matrices/matrixutils.py:108-113``).  This module provides:

* :func:`spmv_numpy` — the exact sequential-order host loop (bit-compatible
  with the reference C++ loop and the bundled ``golden.bin`` files), used for
  exactness tests;
* jitted, loop-free ``jnp`` executors for every container format — the
  golden path that the plan executors are verified against.

All device executors take a :class:`..ops.semiring.Semiring` and are pure
functions of pytrees, so they compose with jit / grad / vmap / shard_map.
"""

from __future__ import annotations

from functools import partial
from typing import Any, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..formats.containers import BSR, COO, CSC, CSR, ELL
from . import semiring as sr

Array = Any


# ---------------------------------------------------------------------------
# host-side exact loop (SoftwareSpMV.cpp:50-70 semantics)
# ---------------------------------------------------------------------------

def spmv_numpy(a, x: np.ndarray, y: Optional[np.ndarray] = None) -> np.ndarray:
    """Sequential-order SpMV on the host: ``y += A @ x``.

    For CSC this accumulates in exactly the nonzero storage order of the
    reference loop (``SoftwareSpMV.cpp:59-64``), so float64 results are
    bit-identical to the reference software path and to the bundled goldens
    (scipy's CSC matvec uses the same order).  ``np.add.at`` is unbuffered
    and applies updates in element order.
    """
    if isinstance(a, CSC):
        indptr = np.asarray(a.indptr, dtype=np.int64)
        rows = np.asarray(a.indices, dtype=np.int64) & 0x3FFFFFFF
        data = np.asarray(a.data)
        cols = np.repeat(np.arange(a.shape[1], dtype=np.int64), np.diff(indptr))
        out = np.zeros(a.shape[0], dtype=np.result_type(data, x)) if y is None \
            else y.copy()
        np.add.at(out, rows, data * np.asarray(x)[cols])
        return out
    if isinstance(a, CSR):
        indptr = np.asarray(a.indptr, dtype=np.int64)
        cols = np.asarray(a.indices, dtype=np.int64)
        data = np.asarray(a.data)
        rows = np.repeat(np.arange(a.shape[0], dtype=np.int64), np.diff(indptr))
        out = np.zeros(a.shape[0], dtype=np.result_type(data, x)) if y is None \
            else y.copy()
        np.add.at(out, rows, data * np.asarray(x)[cols])
        return out
    if isinstance(a, COO):
        out = np.zeros(a.shape[0], dtype=np.result_type(a.data, x)) if y is None \
            else y.copy()
        np.add.at(out, np.asarray(a.row, dtype=np.int64),
                  np.asarray(a.data) * np.asarray(x)[np.asarray(a.col, dtype=np.int64)])
        return out
    raise TypeError(f"unsupported container {type(a)}")


def golden(a, x: Optional[np.ndarray] = None) -> np.ndarray:
    """y = A @ x with x defaulting to ones — the golden generator
    (``matrixutils.py:105-113``)."""
    if x is None:
        x = np.ones(a.shape[1], dtype=np.asarray(a.data).dtype
                    if np.asarray(a.data).dtype.kind == "f" else np.float64)
    return spmv_numpy(a, x)


# ---------------------------------------------------------------------------
# jitted segment-sum executors (device golden path)
# ---------------------------------------------------------------------------

def _expand_indptr(indptr: Array, nnz: int) -> Array:
    """Per-nonzero major index from compressed pointers, statically shaped.

    ``searchsorted(indptr[1:], arange(nnz), 'right')`` maps nz position e to
    the segment whose [indptr[j], indptr[j+1]) window contains e — the
    jit-compatible analog of the reference's ``StreamDelta`` +
    ``StreamRepeatElem`` column expansion
    (``chisel/frontend/SpMVFrontendNewCache.scala:69-99``).
    """
    positions = jnp.arange(nnz, dtype=indptr.dtype)
    return jnp.searchsorted(indptr[1:], positions, side="right")


@partial(jax.jit, static_argnames=("semiring", "num_rows"))
def _spmv_coo_impl(data, row, col, x, *, semiring: str, num_rows: int):
    s = sr.get(semiring)
    products = s.mul(data, jnp.take(x, col, axis=0))
    return s.segment_reduce(products, row, num_rows)


def spmv(a, x: Array, semiring=sr.PLUS_TIMES, y: Optional[Array] = None) -> Array:
    """Generalized sparse matrix-vector product ``y (+)= A (x) x`` on device.

    Works for every container; jit-friendly (static shapes, no Python loops
    over data).  This is the correctness oracle for the plan executors.
    """
    s = sr.get(semiring)
    num_rows = a.shape[0]
    if isinstance(a, CSC):
        col = _expand_indptr(jnp.asarray(a.indptr), int(a.data.shape[0]))
        row = jnp.asarray(a.indices) & 0x3FFFFFFF
        data = jnp.asarray(a.data)
    elif isinstance(a, CSR):
        row = _expand_indptr(jnp.asarray(a.indptr), int(a.data.shape[0]))
        col = jnp.asarray(a.indices)
        data = jnp.asarray(a.data)
    elif isinstance(a, COO):
        row, col, data = jnp.asarray(a.row), jnp.asarray(a.col), jnp.asarray(a.data)
    elif isinstance(a, ELL):
        return _spmv_ell(a, x, s, y)
    elif isinstance(a, BSR):
        return _spmv_bsr(a, x, s, y)
    else:
        raise TypeError(f"unsupported container {type(a)}")
    out = _spmv_coo_impl(data, row, col, jnp.asarray(x),
                         semiring=s.name, num_rows=num_rows)
    return out if y is None else s.add(jnp.asarray(y), out)


def _spmv_ell(a: ELL, x: Array, s: sr.Semiring, y: Optional[Array]) -> Array:
    """ELL executor: a dense gather + row reduction — fully regular."""
    data = jnp.asarray(a.data)
    gathered = jnp.take(jnp.asarray(x), jnp.asarray(a.indices), axis=0)
    products = s.mul(data, gathered)
    if s.name == "plus_times":
        out = jnp.sum(products, axis=1)
    elif s.name in ("max_plus", "max_times"):
        out = jnp.max(products, axis=1)
    elif s.name == "min_plus":
        out = jnp.min(products, axis=1)
    else:
        raise NotImplementedError(s.name)
    return out if y is None else s.add(jnp.asarray(y), out)


def _spmv_bsr(a: BSR, x: Array, s: sr.Semiring, y: Optional[Array]) -> Array:
    """BSR executor: per-block dense matvec + block-row segment reduce."""
    br, bc = a.blocksize
    data = jnp.asarray(a.data)                           # (nb, br, bc)
    xblk = jnp.asarray(x).reshape(-1, bc)                # (cols/bc, bc)
    gathered = jnp.take(xblk, jnp.asarray(a.indices), axis=0)  # (nb, bc)
    if s.name == "plus_times":
        contrib = jnp.einsum("nij,nj->ni", data, gathered,
                             preferred_element_type=data.dtype,
                             precision=jax.lax.Precision.HIGHEST)
    else:
        contrib = s.mul(data, gathered[:, None, :])
        contrib = jax.lax.reduce(contrib, jnp.asarray(s.zero, data.dtype),
                                 s.add, (2,))
    block_row = _expand_indptr(jnp.asarray(a.indptr), a.nblocks)
    out = s.segment_reduce(contrib, block_row, a.shape[0] // br).reshape(-1)
    return out if y is None else s.add(jnp.asarray(y), out)


def spmm(a, b: Array, semiring=sr.PLUS_TIMES) -> Array:
    """Sparse x dense: ``Y = A @ B`` with B of shape (cols, k) — reference
    executor for the SpMM kernels (multi-RHS, BASELINE.json config 3)."""
    s = sr.get(semiring)
    if isinstance(a, BSR):
        br, bc = a.blocksize
        data = jnp.asarray(a.data)
        bmat = jnp.asarray(b).reshape(a.shape[1] // bc, bc, -1)
        gathered = jnp.take(bmat, jnp.asarray(a.indices), axis=0)  # (nb, bc, k)
        contrib = jnp.einsum("nij,njk->nik", data, gathered,
                             preferred_element_type=data.dtype,
                             precision=jax.lax.Precision.HIGHEST)
        block_row = _expand_indptr(jnp.asarray(a.indptr), a.nblocks)
        out = jax.ops.segment_sum(contrib, block_row, a.shape[0] // br)
        return out.reshape(a.shape[0], -1)
    if isinstance(a, CSR):
        row = _expand_indptr(jnp.asarray(a.indptr), int(np.asarray(a.data).shape[0]))
        col, data = jnp.asarray(a.indices), jnp.asarray(a.data)
    elif isinstance(a, CSC):
        col = _expand_indptr(jnp.asarray(a.indptr), int(np.asarray(a.data).shape[0]))
        row, data = jnp.asarray(a.indices) & 0x3FFFFFFF, jnp.asarray(a.data)
    elif isinstance(a, COO):
        row, col, data = jnp.asarray(a.row), jnp.asarray(a.col), jnp.asarray(a.data)
    else:
        raise TypeError(f"unsupported container {type(a)}")
    products = s.mul(data[:, None], jnp.take(jnp.asarray(b), col, axis=0))
    if s.name != "plus_times":
        raise NotImplementedError("SpMM reference only for plus_times")
    return jax.ops.segment_sum(products, row, a.shape[0])
