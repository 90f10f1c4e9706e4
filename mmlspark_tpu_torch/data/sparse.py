"""Sparse rows for GBDT ingest: CSR matrices and sparse table columns.

The port's copy of the CSR part of ``mmlspark_tpu/data/sparse.py``.
:class:`CSRMatrix` is the ``LGBM_DatasetCreateFromCSRSpark`` analogue (the
reference's ``lightgbm/LightGBMUtils.scala:246-266``): implicit entries are
0.0, an explicit NaN is missing, as on the dense path. Sparsity lives only
on the host: binning maps a CSR matrix straight to the uint8 bins that
training uploads. :class:`SparseRows` is a sparse table column backed by
three flat arrays. The reference's ``SparseBatch``, ``from_lists`` and
``combine_csr`` serve only the VW learners and come with them.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np


def _gather_rows(indptr: np.ndarray, rows: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The entries of ``rows`` of a CSR layout: (source position of each
    gathered entry, new row pointers)."""
    rows = np.asarray(rows, dtype=np.int64)
    counts = np.diff(indptr)[rows]
    new_indptr = np.zeros(len(rows) + 1, dtype=np.int64)
    np.cumsum(counts, out=new_indptr[1:])
    total = int(new_indptr[-1])
    pos = (np.repeat(indptr[rows], counts) + np.arange(total, dtype=np.int64)
           - np.repeat(new_indptr[:-1], counts))
    return pos, new_indptr


@dataclasses.dataclass
class CSRMatrix:
    """Host-side CSR matrix: ``data`` float64 (nnz,), ``indices`` int32 column
    of each entry, ``indptr`` int64 (N+1,) row pointers."""

    data: np.ndarray
    indices: np.ndarray
    indptr: np.ndarray
    shape: Tuple[int, int]

    def __post_init__(self):
        self.data = np.asarray(self.data, dtype=np.float64)
        self.indices = np.asarray(self.indices, dtype=np.int32)
        self.indptr = np.asarray(self.indptr, dtype=np.int64)
        self.shape = (int(self.shape[0]), int(self.shape[1]))

    @property
    def num_rows(self) -> int:
        return self.shape[0]

    @property
    def num_features(self) -> int:
        return self.shape[1]

    @property
    def nnz(self) -> int:
        return len(self.data)

    @staticmethod
    def from_scipy(m) -> "CSRMatrix":
        csr = m.tocsr() if hasattr(m, "tocsr") else m
        return CSRMatrix(data=csr.data, indices=csr.indices, indptr=csr.indptr,
                         shape=tuple(csr.shape))

    @staticmethod
    def from_rows(rows: Sequence[Tuple[np.ndarray, np.ndarray]],
                  num_features: int = 0) -> "CSRMatrix":
        """From per-row (indices, values) pairs; ``num_features`` pins the
        width (0: the largest index + 1) and an index past it raises."""
        idx_lists = [np.asarray(r[0], dtype=np.int64) for r in rows]
        val_lists = [np.asarray(r[1], dtype=np.float64) for r in rows]
        lens = np.array([len(i) for i in idx_lists], dtype=np.int64)
        indptr = np.zeros(len(rows) + 1, dtype=np.int64)
        np.cumsum(lens, out=indptr[1:])
        indices = np.concatenate(idx_lists) if idx_lists else np.zeros(0, dtype=np.int64)
        data = np.concatenate(val_lists) if val_lists else np.zeros(0, dtype=np.float64)
        max_idx = int(indices.max()) if len(indices) else -1
        if num_features and max_idx >= num_features:
            raise ValueError(f"sparse feature index {max_idx} out of range for "
                             f"num_features={num_features}")
        f = int(num_features or max_idx + 1)
        return CSRMatrix(data=data, indices=indices, indptr=indptr, shape=(len(rows), f))

    @staticmethod
    def from_dense(dense: np.ndarray) -> "CSRMatrix":
        """Every nonzero or NaN cell of ``dense`` as an explicit entry."""
        dense = np.asarray(dense, dtype=np.float64)
        n, f = dense.shape
        mask = (dense != 0) | np.isnan(dense)
        indptr = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(mask.sum(axis=1), out=indptr[1:])
        rows, cols = np.nonzero(mask)
        return CSRMatrix(data=dense[rows, cols], indices=cols, indptr=indptr, shape=(n, f))

    def row_slice(self, lo: int, hi: int) -> "CSRMatrix":
        a, b = self.indptr[lo], self.indptr[hi]
        return CSRMatrix(data=self.data[a:b], indices=self.indices[a:b],
                         indptr=self.indptr[lo: hi + 1] - a, shape=(hi - lo, self.shape[1]))

    def take_rows(self, idx: np.ndarray) -> "CSRMatrix":
        """Rows ``idx`` (positions or a boolean mask), in that order."""
        idx = np.asarray(idx)
        if idx.dtype == bool:
            idx = np.nonzero(idx)[0]
        pos, indptr = _gather_rows(self.indptr, idx)
        return CSRMatrix(data=self.data[pos], indices=self.indices[pos], indptr=indptr,
                         shape=(len(idx), self.shape[1]))

    def to_csc(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Column-major view: (col_indptr (F+1,), row_ids (nnz,), values
        (nnz,)), from one stable argsort over the column ids (a radix sort
        where they fit 16 bits: the same order)."""
        cols = self.indices
        if self.num_features <= 1 << 16:
            cols = cols.astype(np.uint16)
        order = np.argsort(cols, kind="stable")
        row_ids = np.repeat(np.arange(self.num_rows, dtype=np.int64),
                            np.diff(self.indptr))[order]
        col_indptr = np.zeros(self.num_features + 1, dtype=np.int64)
        np.cumsum(np.bincount(self.indices, minlength=self.num_features), out=col_indptr[1:])
        return col_indptr, row_ids, self.data[order]

    def to_dense(self, dtype=np.float64) -> np.ndarray:
        out = np.zeros(self.shape, dtype=dtype)
        rows = np.repeat(np.arange(self.num_rows), np.diff(self.indptr))
        out[rows, self.indices] = self.data
        return out


class SparseRows:
    """A sparse table column: row i is ``(indices[a:b], values[a:b])`` with
    ``a, b = indptr[i], indptr[i + 1]``. Three flat arrays back the whole
    column (``indices`` int32, ``values`` float32, ``indptr`` int64), and it
    acts enough like a 1-D object array of (indices, values) tuples to live
    in a :class:`~mmlspark_tpu_torch.data.table.Table`: row access,
    iteration, masks and fancy indexing."""

    dtype = np.dtype(object)
    ndim = 1

    def __init__(self, indices: np.ndarray, values: np.ndarray, indptr: np.ndarray, dim: int):
        self.indices = np.asarray(indices, dtype=np.int32)
        self.values = np.asarray(values, dtype=np.float32)
        self.indptr = np.asarray(indptr, dtype=np.int64)
        self.dim = int(dim)

    @property
    def shape(self) -> Tuple[int]:
        return (len(self.indptr) - 1,)

    @property
    def nnz(self) -> int:
        return int(self.indptr[-1])

    def __len__(self) -> int:
        return len(self.indptr) - 1

    def __getitem__(self, key):
        if isinstance(key, (int, np.integer)):
            i = int(key)
            n = len(self)
            if i < 0:
                i += n
            if not 0 <= i < n:
                raise IndexError(f"row {key} out of range for {n} rows")
            a, b = self.indptr[i], self.indptr[i + 1]
            return (self.indices[a:b], self.values[a:b])
        if isinstance(key, slice):
            start, stop, step = key.indices(len(self))
            if step == 1:
                stop = max(stop, start)
                a, b = self.indptr[start], self.indptr[stop]
                return SparseRows(self.indices[a:b], self.values[a:b],
                                  self.indptr[start: stop + 1] - a, self.dim)
            return self.take(np.arange(start, stop, step))
        key = np.asarray(key)
        if key.dtype == bool:
            key = np.nonzero(key)[0]
        return self.take(key)

    def take(self, rows: np.ndarray) -> "SparseRows":
        pos, indptr = _gather_rows(self.indptr, rows)
        return SparseRows(self.indices[pos], self.values[pos], indptr, self.dim)

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def copy(self) -> "SparseRows":
        return SparseRows(self.indices.copy(), self.values.copy(), self.indptr.copy(), self.dim)

    def to_object_column(self) -> np.ndarray:
        """The object column of (indices, values) tuples."""
        out = np.empty(len(self), dtype=object)
        for i in range(len(self)):
            out[i] = self[i]
        return out

    @staticmethod
    def concat(parts: Sequence["SparseRows"]) -> "SparseRows":
        dim = max(p.dim for p in parts)
        indptrs = [parts[0].indptr]
        for p in parts[1:]:
            indptrs.append(p.indptr[1:] + (indptrs[-1][-1] - p.indptr[0]))
        return SparseRows(np.concatenate([p.indices for p in parts]),
                          np.concatenate([p.values for p in parts]),
                          np.concatenate(indptrs), dim)

    def __repr__(self) -> str:
        return f"SparseRows[{len(self)} rows, nnz={self.nnz}, dim={self.dim}]"


def csr_column_to_matrix(column, num_features: int = 0) -> CSRMatrix:
    """A sparse column as a CSRMatrix; ``num_features`` pins the width (0:
    the column's own) and an explicit index past it raises. A
    :class:`SparseRows` column converts without a row loop."""
    if isinstance(column, SparseRows):
        f = int(num_features or column.dim)
        if column.nnz and int(column.indices.max()) >= f:
            raise ValueError(f"sparse feature index {int(column.indices.max())} out of range "
                             f"for num_features={f}")
        return CSRMatrix(data=column.values, indices=column.indices, indptr=column.indptr,
                         shape=(len(column), f))
    return CSRMatrix.from_rows(list(column), num_features=num_features)


def is_sparse_column(column) -> bool:
    """True when a column holds per-row (indices, values) sparse rows."""
    if isinstance(column, SparseRows):
        return True
    if column.dtype != object or len(column) == 0:
        return False
    head = column[0]
    return (isinstance(head, tuple) and len(head) == 2
            and np.asarray(head[0]).ndim == 1 and np.asarray(head[1]).ndim == 1
            and np.issubdtype(np.asarray(head[0]).dtype, np.integer))
