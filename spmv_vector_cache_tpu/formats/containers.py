"""Sparse-matrix containers as JAX pytrees.

A re-design of the reference's matrix layer:

* the reference holds one format, CSC with ``uint32`` indices and ``float64``
  values, zero-copy over a raw memory blob (``software/SparseMatrix.h:5-70``,
  ``software/SparseMatrix.cpp:29-50``);
* this library holds CSR / CSC / COO / BSR / ELL as immutable pytree
  dataclasses whose leaves may be numpy *or* JAX arrays, so a matrix can move
  between host preprocessing and jitted device code without copies or wrapper
  classes.

Shapes are static metadata (pytree aux data), which is what XLA needs: a
container with a given (shape, nnz, dtype) signature always retraces to the
same program.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import jax
import numpy as np

Array = Any  # numpy or jax array


def _fields(obj) -> Tuple[str, ...]:
    return tuple(f.name for f in dataclasses.fields(obj))


class _SparseBase:
    """Shared pytree plumbing for the sparse containers.

    Array fields are pytree leaves; ``shape`` (and any other non-array
    field) is aux data.  Subclasses list array fields in ``_array_fields``.
    """

    _array_fields: Tuple[str, ...] = ()

    def tree_flatten(self):
        children = tuple(getattr(self, f) for f in self._array_fields)
        aux = tuple(
            getattr(self, f) for f in _fields(self) if f not in self._array_fields
        )
        return children, aux

    @classmethod
    def tree_unflatten(cls, aux, children):
        kwargs = dict(zip(cls._array_fields, children))
        aux_names = [f for f in _fields_of(cls) if f not in cls._array_fields]
        kwargs.update(dict(zip(aux_names, aux)))
        return cls(**kwargs)

    # -- conveniences -----------------------------------------------------
    @property
    def dtype(self):
        return self.data.dtype

    @property
    def rows(self) -> int:
        return self.shape[0]

    @property
    def cols(self) -> int:
        return self.shape[1]

    def to_device(self):
        """Move all array leaves onto the default JAX device."""
        leaves, aux = self.tree_flatten()
        return type(self).tree_unflatten(aux, tuple(jax.numpy.asarray(l) for l in leaves))

    def to_host(self):
        leaves, aux = self.tree_flatten()
        return type(self).tree_unflatten(aux, tuple(np.asarray(l) for l in leaves))


def _fields_of(cls) -> Tuple[str, ...]:
    return tuple(f.name for f in dataclasses.fields(cls))


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class CSR(_SparseBase):
    """Compressed sparse row.  ``indptr``: (rows+1,), ``indices``: (nnz,) col ids."""

    data: Array
    indices: Array
    indptr: Array
    shape: Tuple[int, int]

    _array_fields = ("data", "indices", "indptr")

    @property
    def nnz(self) -> int:
        return int(self.data.shape[0])


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class CSC(_SparseBase):
    """Compressed sparse column — the reference's native format.

    ``indptr``: (cols+1,) column pointers, ``indices``: (nnz,) row ids,
    matching the on-disk blobs produced by the reference's converter
    (``matrices/matrixutils.py:187-260``).
    """

    data: Array
    indices: Array
    indptr: Array
    shape: Tuple[int, int]

    _array_fields = ("data", "indices", "indptr")

    @property
    def nnz(self) -> int:
        return int(self.data.shape[0])


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class COO(_SparseBase):
    """Coordinate format: parallel (row, col, data) arrays of length nnz."""

    data: Array
    row: Array
    col: Array
    shape: Tuple[int, int]

    _array_fields = ("data", "row", "col")

    @property
    def nnz(self) -> int:
        return int(self.data.shape[0])


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class BSR(_SparseBase):
    """Block sparse row: dense (br, bc) blocks on a CSR skeleton.

    ``data``: (nblocks, br, bc); ``indices``: (nblocks,) block-column ids;
    ``indptr``: (rows/br + 1,).  The dense blocks are what feeds the matrix units in
    the BSR SpMV/SpMM kernels.
    """

    data: Array
    indices: Array
    indptr: Array
    shape: Tuple[int, int]
    blocksize: Tuple[int, int]

    _array_fields = ("data", "indices", "indptr")

    @property
    def nnz(self) -> int:
        return int(self.data.shape[0]) * self.blocksize[0] * self.blocksize[1]

    @property
    def nblocks(self) -> int:
        return int(self.data.shape[0])


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class ELL(_SparseBase):
    """ELLPACK: fixed width per row, padded — the static-shape-friendly format.

    ``data``/``indices``: (rows, width); padding slots hold value 0 and a
    valid in-range column id (0), so padded lanes contribute the semiring
    zero and never index out of bounds.
    """

    data: Array
    indices: Array
    shape: Tuple[int, int]

    _array_fields = ("data", "indices")

    @property
    def width(self) -> int:
        return int(self.data.shape[1])

    @property
    def nnz(self) -> int:  # counts padding; true nnz is not tracked here
        return int(self.data.shape[0]) * self.width
