"""DIA (diagonal) format: container, conversions, and the tile plan.

The reference bundles diagonal test matrices (``matrices/dia64-uint64``)
and its whole design question is *where the irregularly-accessed vector
lives* (SURVEY.md §2.1).  For matrices whose nonzeros concentrate on a few
diagonals, the irregular access can disappear entirely: store one value
vector per diagonal and turn ``x[col]`` into a **static slice** of the
padded x — no gather, no per-element index stream.  The byte cost drops
from 8 B/nnz (value + column id) to 4 B/nnz + O(1).

Layout built here (consumed by ``ops/spmv_dia.py``):

* ``vals``: (T, D, S, 128) — block t covers ``S*128`` consecutive rows;
  ``vals[t, k, i, l]`` is A[r, r + offsets[k]] for r = t*S*128 + i*128 + l,
  so each (t, k) value run is contiguous;
* x is padded by ``pad_left`` zeros (covering the most negative offset),
  so diagonal k of block t reads x_pad[pad_left + offsets[k] + t*S*128 :]
  contiguously.

``split_diagonal`` is the hybrid splitter (the strategy-selection role of
the reference's per-matrix bitfile choice, ``HWSpMVFactory.cpp:20-38``):
diagonals dense enough to pay for their padded storage go to DIA, the
rest stays CSR for the SELL path; ``y = y_dia + y_sell``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import jax
import numpy as np

from .containers import COO, CSC, CSR

Array = Any

#: 128-row groups per DIA block (8192 rows): the row padding granularity
DIA_SUBLANES = 64


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class DIA:
    """Diagonal container: ``data[k, r] = A[r, r + offsets[k]]`` (row-major
    orientation — note scipy.sparse.dia_matrix stores the column-major dual
    ``data[k, c] = A[c - off, c]``; converters below translate).
    Slots outside the matrix carry 0."""

    data: Array                  # (D, rows)
    offsets: Array               # (D,) int64, strictly increasing
    shape: Tuple[int, int]

    _array_fields = ("data", "offsets")

    def tree_flatten(self):
        return (self.data, self.offsets), (self.shape,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(data=children[0], offsets=children[1], shape=aux[0])

    @property
    def ndiag(self) -> int:
        return int(self.data.shape[0])

    @property
    def nnz(self) -> int:
        return int((np.asarray(self.data) != 0).sum())

    @property
    def dtype(self):
        return self.data.dtype


def _csr_fields(a: CSR):
    indptr = np.asarray(a.indptr, dtype=np.int64)
    indices = np.asarray(a.indices, dtype=np.int64) & 0x3FFFFFFF
    data = np.asarray(a.data)
    rows, cols = a.shape
    nz_row = np.repeat(np.arange(rows, dtype=np.int64), np.diff(indptr))
    return rows, cols, nz_row, indices, data


def csr_to_dia(a: CSR, *, max_diags: int = 512) -> DIA:
    """Exact conversion (every nonzero lands on a stored diagonal)."""
    rows, cols, nz_row, indices, data = _csr_fields(a)
    d = indices - nz_row
    offsets = np.unique(d)
    if offsets.size > max_diags:
        raise ValueError(
            f"matrix has {offsets.size} distinct diagonals "
            f"(max_diags={max_diags}); use split_diagonal for a hybrid")
    vd = np.zeros((offsets.size, rows), data.dtype)
    k = np.searchsorted(offsets, d)
    vd[k, nz_row] = data
    return DIA(data=vd, offsets=offsets, shape=a.shape)


def dia_to_csr(a: DIA) -> CSR:
    data = np.asarray(a.data)
    offsets = np.asarray(a.offsets)
    rows, cols = a.shape
    rr, kk = [], []
    for k, off in enumerate(offsets):
        r = np.arange(max(0, -off), min(rows, cols - off), dtype=np.int64)
        r = r[data[k, r] != 0]
        rr.append(r)
        kk.append(np.full(r.shape, k, np.int64))
    r = np.concatenate(rr) if rr else np.zeros(0, np.int64)
    k = np.concatenate(kk) if kk else np.zeros(0, np.int64)
    c = r + offsets[k] if r.size else r
    order = np.lexsort((c, r))
    r, c = r[order], c[order]
    v = data[k[order], r]
    indptr = np.zeros(rows + 1, np.int64)
    np.add.at(indptr, r + 1, 1)
    indptr = np.cumsum(indptr)
    return CSR(data=v, indices=c.astype(np.int32), indptr=indptr,
               shape=a.shape)


def from_scipy_dia(m) -> DIA:
    """scipy.sparse.dia_matrix -> row-major DIA."""
    offsets = np.asarray(m.offsets, dtype=np.int64)
    order = np.argsort(offsets)
    offsets = offsets[order]
    rows, cols = m.shape
    vd = np.zeros((offsets.size, rows), m.data.dtype)
    for k, off in enumerate(offsets):
        r0, r1 = max(0, -off), min(rows, cols - off)
        if r1 > r0:
            r = np.arange(r0, r1)
            vd[k, r] = m.data[order[k], r + off]
    return DIA(data=vd, offsets=offsets, shape=m.shape)


def split_diagonal(a: CSR, *, min_diag_fill: float = 0.5,
                   max_diags: int = 96
                   ) -> Tuple[Optional[DIA], Optional[CSR], float]:
    """Hybrid split: (dense-diagonal part, residual CSR, coverage).

    A diagonal is extracted when its population is at least
    ``min_diag_fill`` of its in-matrix length (padding below that wastes
    more bandwidth than the 4 B/nnz format saves), keeping at most the
    ``max_diags`` densest.  Returns (None, a, 0.0) when nothing qualifies
    and (dia, None, 1.0) when everything does.
    """
    rows, cols, nz_row, indices, data = _csr_fields(a)
    if data.size == 0:
        return None, a, 0.0
    d = indices - nz_row
    offsets, counts = np.unique(d, return_counts=True)
    diag_len = np.minimum(rows, cols - offsets)
    diag_len = np.minimum(diag_len, rows + offsets)
    keep = counts >= np.maximum(1.0, min_diag_fill * diag_len)
    if keep.sum() > max_diags:
        # keep the max_diags most populated
        order = np.argsort(counts[keep])[::-1][:max_diags]
        kept_offs = offsets[keep][order]
        keep = np.isin(offsets, kept_offs)
    if not keep.any():
        return None, a, 0.0
    sel_offs = offsets[keep]
    on_dia = np.isin(d, sel_offs)
    coverage = float(on_dia.sum()) / float(data.size)

    vd = np.zeros((sel_offs.size, rows), data.dtype)
    k = np.searchsorted(sel_offs, d[on_dia])
    vd[k, nz_row[on_dia]] = data[on_dia]
    dia = DIA(data=vd, offsets=sel_offs, shape=a.shape)

    if on_dia.all():
        return dia, None, 1.0
    rest_mask = ~on_dia
    rest_indptr = np.zeros(rows + 1, np.int64)
    np.add.at(rest_indptr, nz_row[rest_mask] + 1, 1)
    rest = CSR(data=data[rest_mask],
               indices=indices[rest_mask].astype(np.int32),
               indptr=np.cumsum(rest_indptr), shape=a.shape)
    return dia, rest, coverage


# ---------------------------------------------------------------------------
# device plan
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DiaStats:
    nnz: int                 # populated slots
    ndiag: int
    num_steps: int
    fill: float              # nnz / (D * padded rows)
    bytes_per_nnz: float     # streamed value bytes per populated slot
    x_rows: int              # padded x length in 128-element rows

    def as_dict(self):
        return dataclasses.asdict(self)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class DiaPlan:
    """Tiled DIA layout ready for the diagonal executor (see module
    docstring).

    ``offsets`` is static aux data: the executor specializes its slices
    per distinct offset pattern — the analog of the reference flashing a
    variant-specific bitfile per matrix class.
    """

    vals: Array                       # (T, D, S, 128); (T, 2D, S, 128) df64
    offsets: Tuple[int, ...]          # static, increasing
    shape: Tuple[int, int]
    sublanes: int                     # S
    pad_left: int                     # flat x left pad (multiple of 128)
    x_rows: int                       # padded x image height
    stats: DiaStats
    #: double-float layout: vals channels [0:D] hold f32 value highs and
    #: [D:2D] the f32 lows (hi + lo == the f64 value) — the f32-pair form
    #: of the reference's 64-bit SpMVData (see ops/df64.py)
    double: bool = False

    def tree_flatten(self):
        return (self.vals,), (self.offsets, self.shape, self.sublanes,
                              self.pad_left, self.x_rows, self.stats,
                              self.double)

    @classmethod
    def tree_unflatten(cls, aux, children):
        offsets, shape, sublanes, pad_left, x_rows, stats, double = aux
        return cls(vals=children[0], offsets=offsets, shape=shape,
                   sublanes=sublanes, pad_left=pad_left, x_rows=x_rows,
                   stats=stats, double=double)

    @property
    def num_steps(self) -> int:
        return int(self.vals.shape[0])

    def to_device(self):
        return dataclasses.replace(self, vals=jax.numpy.asarray(self.vals))


def build_dia_plan(a, *, sublanes: int = DIA_SUBLANES,
                   value_dtype=np.float32) -> DiaPlan:
    """Build the (T, D, S, 128) tile plan from a DIA/CSR/CSC/COO container.

    ``value_dtype=np.float64`` builds a **double-float** plan: values are
    stored as (hi, lo) f32 pairs stacked along the diagonal axis and the
    executor computes with f64-equivalent (~2^-48) accuracy using error-free
    transformations (``ops/df64.py``) — precision parity with the
    reference's double-precision datapath at 8 B/nnz.
    """
    if not isinstance(a, DIA):
        if isinstance(a, (CSC, COO)):
            from .convert import coo_to_csr, csc_to_csr
            a = csc_to_csr(a) if isinstance(a, CSC) else coo_to_csr(a)
        a = csr_to_dia(a)
    rows, cols = a.shape
    S = sublanes
    RS = S * 128
    offsets = tuple(int(o) for o in np.asarray(a.offsets))
    D = len(offsets)
    nr = rows + ((-rows) % RS)
    T = nr // RS
    double = np.dtype(value_dtype) == np.float64
    if double:
        from ..ops.df64 import split_f64
        vd = np.zeros((D, nr), np.float64)
        vd[:, :rows] = np.asarray(a.data, np.float64)
        hi, lo = split_f64(vd)
        store = np.concatenate([hi, lo], axis=0)       # (2D, nr) f32
    else:
        vd = np.zeros((D, nr), value_dtype)
        vd[:, :rows] = np.asarray(a.data, value_dtype)
        store = vd
    vals = np.ascontiguousarray(
        store.reshape(store.shape[0], T, S, 128).transpose(1, 0, 2, 3))

    omin = min(offsets) if offsets else 0
    omax = max(offsets) if offsets else 0
    pad_left = ((max(0, -omin)) + 127) // 128 * 128
    # padded x must cover every diagonal's slice and all of x
    x_rows = max((pad_left + T * RS + max(omax, 0) + 127) // 128,
                 (pad_left + cols + 127) // 128)

    nnz = int((vd != 0).sum())
    streamed = store.shape[0] * nr * 4 if double else \
        D * nr * np.dtype(value_dtype).itemsize
    stats = DiaStats(
        nnz=nnz, ndiag=D, num_steps=T,
        fill=float(nnz) / float(D * nr) if D else 0.0,
        bytes_per_nnz=streamed / nnz if nnz else 0.0,
        x_rows=x_rows)
    return DiaPlan(vals=vals, offsets=offsets, shape=(rows, cols),
                   sublanes=S, pad_left=pad_left, x_rows=x_rows, stats=stats,
                   double=double)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class HybridPlan:
    """DIA part + SELL residual: ``y = dia(x) + sell(x)``.

    The port of the reference's BufferSel hybrid idea
    (``SpMVFrontendBufferSel.scala``): route each nonzero to the placement
    strategy its locality deserves, merge with one add."""

    dia: DiaPlan
    rest: Any                         # SellPlan

    def tree_flatten(self):
        return (self.dia, self.rest), ()

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(dia=children[0], rest=children[1])

    @property
    def shape(self):
        return self.dia.shape

    def to_device(self):
        return HybridPlan(dia=self.dia.to_device(),
                          rest=self.rest.to_device())
