"""Sparse rows for GBDT ingest: CSR matrices and sparse table columns.

The port's copy of the CSR part of ``mmlspark_tpu/data/sparse.py``.
:class:`CSRMatrix` is the ``LGBM_DatasetCreateFromCSRSpark`` analogue (the
reference's ``lightgbm/LightGBMUtils.scala:246-266``): implicit entries are
0.0, an explicit NaN is missing, as on the dense path. Sparsity lives only
on the host: binning maps a CSR matrix straight to the uint8 bins that
training uploads. :class:`SparseRows` is a sparse table column backed by
three flat arrays. :class:`SparseBatch` is the VW learners' padded
(N, K) layout, with its converters (``from_lists``, ``combine_csr``,
``dense_to_batch``, ``column_to_batch``, ``batch_to_column``): host numpy,
the reference's arithmetic, so a featurized column and a batch equal the
reference's bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

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
class SparseBatch:
    indices: np.ndarray  # (N, K) int32
    values: np.ndarray  # (N, K) float32
    dim: int  # feature-space size (1 << num_bits)

    @property
    def num_rows(self) -> int:
        return self.indices.shape[0]

    @property
    def max_active(self) -> int:
        return self.indices.shape[1]

    def to_dense(self) -> np.ndarray:
        out = np.zeros((self.num_rows, self.dim), dtype=np.float32)
        rows = np.repeat(np.arange(self.num_rows), self.max_active)
        np.add.at(out, (rows, self.indices.reshape(-1)), self.values.reshape(-1))
        return out

    @staticmethod
    def from_csr(
        indices: np.ndarray,
        values: np.ndarray,
        indptr: np.ndarray,
        dim: int,
        pad_to: int = 0,
    ) -> "SparseBatch":
        """Pad CSR arrays straight into the (N, K) device layout with one
        scatter — the fast path ``from_lists`` assembly reduces to when rows
        arrive as flat (indices, values, indptr) instead of n Python lists.
        Assumes duplicate indices are already combined (see
        :func:`combine_csr`); K matches ``from_lists`` (max row length,
        floor 1, or ``pad_to``)."""
        indptr = np.asarray(indptr, dtype=np.int64)
        counts = np.diff(indptr)
        n = len(counts)
        k = int(max(counts.max() if n else 0, 1, pad_to))
        ind2d = np.zeros((n, k), dtype=np.int32)
        val2d = np.zeros((n, k), dtype=np.float32)
        nnz = int(indptr[-1]) if n else 0
        if nnz:
            row_ids = np.repeat(np.arange(n, dtype=np.int64), counts)
            within = np.arange(nnz, dtype=np.int64) - indptr[row_ids]
            ind2d[row_ids, within] = indices[:nnz]
            val2d[row_ids, within] = values[:nnz]
        return SparseBatch(indices=ind2d, values=val2d, dim=dim)


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


def from_lists(
    index_lists: Sequence[np.ndarray],
    value_lists: Sequence[np.ndarray],
    dim: int,
    sum_collisions: bool = True,
    pad_to: int = 0,
) -> SparseBatch:
    """Assemble per-row (indices, values) into a padded batch, combining
    duplicate indices within a row (``sumCollisions`` semantics)."""
    combined: List[Tuple[np.ndarray, np.ndarray]] = []
    max_k = 1
    for idx, val in zip(index_lists, value_lists):
        idx = np.asarray(idx, dtype=np.int64)
        val = np.asarray(val, dtype=np.float32)
        if len(idx):
            uniq, inv = np.unique(idx, return_inverse=True)
            if len(uniq) < len(idx):
                if sum_collisions:
                    summed = np.zeros(len(uniq), dtype=np.float32)
                    np.add.at(summed, inv, val)
                    idx, val = uniq, summed
                else:
                    # keep first occurrence per index
                    first = np.full(len(uniq), -1, dtype=np.int64)
                    for pos, u in enumerate(inv):
                        if first[u] < 0:
                            first[u] = pos
                    idx, val = uniq, val[first]
        combined.append((idx, val))
        max_k = max(max_k, len(idx))
    k = max(max_k, pad_to)
    n = len(combined)
    indices = np.zeros((n, k), dtype=np.int32)
    values = np.zeros((n, k), dtype=np.float32)
    for i, (idx, val) in enumerate(combined):
        indices[i, : len(idx)] = idx
        values[i, : len(val)] = val
    return SparseBatch(indices=indices, values=values, dim=dim)


def _combine_ones_padded(
    indices: np.ndarray,
    values: np.ndarray,
    indptr: np.ndarray,
    counts: np.ndarray,
    K: int,
    sum_collisions: bool,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """combine_csr fast path for all-ones values: rows scatter into a padded
    (n, K+1) int32 matrix whose rows sort independently (SIMD sorting
    networks on short rows beat a global radix sort by ~15x), duplicates
    collapse to runs, and a group's summed value is just its run length.
    The extra sentinel column guarantees every row ends with a padding run,
    so each valid run's extent is bounded by the next boundary in the SAME
    row. No zero-trim pass: combined values are always >= 1."""
    n = len(counts)
    nnz = int(indptr[-1])
    sent = np.int32(2**31 - 1)
    W = K + 1
    m = np.full((n, W), sent, dtype=np.int32)
    if bool((counts == K).all()):
        m[:, :K] = indices.astype(np.int32, copy=False).reshape(n, K)
    else:
        row_ids = np.repeat(np.arange(n, dtype=np.int64), counts)
        within = np.arange(nnz, dtype=np.int64) - np.repeat(indptr[:-1], counts)
        m[row_ids, within] = indices
    ms = np.sort(m, axis=1)  # sentinels sort to the tail of each row
    b2 = np.empty((n, W), dtype=bool)
    b2[:, 0] = True
    np.not_equal(ms[:, 1:], ms[:, :-1], out=b2[:, 1:])
    # each row contributes exactly one padding run (the sentinel column
    # guarantees it), so distinct indices per row = boundaries - 1
    ucounts = np.count_nonzero(b2, axis=1) - 1
    has_dup = ucounts < counts
    if not has_dup.any():
        return indices.astype(np.int32, copy=False), values, indptr
    # Duplicate-free rows have ucounts == counts, so the kept run stream IS
    # the output — no per-group destination scatter at all. Values are 1 for
    # singleton runs, so only indices of duplicate-free rows need an
    # original-order overwrite afterwards.
    q = np.flatnonzero(b2.ravel())  # run starts, row-major => sorted per row
    vals_q = ms.ravel()[q]
    keep_q = vals_q != sent  # drop each row's padding run (and empty rows)
    out_idx = vals_q[keep_q]
    if sum_collisions:
        runs = np.empty(len(q), dtype=np.int64)
        np.subtract(q[1:], q[:-1], out=runs[:-1])
        runs[-1] = n * W - q[-1]  # last boundary is always a padding run
        out_val = runs[keep_q].astype(np.float32)
    else:
        out_val = np.ones(len(out_idx), dtype=np.float32)  # first of a 1 is 1
    out_indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(ucounts, out=out_indptr[1:])
    # duplicate-free rows: restore original entry order; work is O(their nnz)
    nd_rows = np.flatnonzero(~has_dup)
    c_nd = counts[nd_rows]
    tot_nd = int(c_nd.sum())
    if tot_nd:
        seg = np.arange(tot_nd, dtype=np.int64) - np.repeat(
            np.cumsum(c_nd) - c_nd, c_nd
        )
        src = np.repeat(indptr[nd_rows], c_nd) + seg
        dst = np.repeat(out_indptr[nd_rows], c_nd) + seg
        out_idx[dst] = indices[src]
    return out_idx, out_val, out_indptr


def combine_csr(
    indices: np.ndarray,
    values: np.ndarray,
    indptr: np.ndarray,
    sum_collisions: bool = True,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Row-wise duplicate-index combine + zero-value trim over flat CSR
    arrays — the vectorized equivalent of ``from_lists`` collision handling
    followed by ``batch_to_column`` trimming, bit-exact with both:

    - a row WITHOUT duplicate indices keeps its original entry order
      (``from_lists`` only touches a row when ``np.unique`` shrinks it);
    - a row WITH duplicates becomes sorted-unique, values summed in float32
      in original occurrence order (``sumCollisions=True``) or taken from
      the first occurrence (``False``);
    - entries whose combined value is exactly 0 are dropped (the padded
      batch cannot distinguish them from padding).

    Returns combined ``(indices int32, values float32, indptr int64)``.
    """
    indices = np.asarray(indices)
    if indices.dtype.kind != "i":
        indices = indices.astype(np.int64)
    values = np.asarray(values, dtype=np.float32)
    indptr = np.asarray(indptr, dtype=np.int64)
    n = len(indptr) - 1
    nnz = int(indptr[-1]) if n else 0
    if nnz == 0:
        return (
            np.zeros(0, dtype=np.int32),
            np.zeros(0, dtype=np.float32),
            np.zeros(n + 1, dtype=np.int64),
        )
    counts = np.diff(indptr)
    all_ones = bool((values == np.float32(1.0)).all())
    K = int(counts.max())
    if (
        all_ones
        and int(indices.max()) < 2**31 - 1
        and K < (1 << 24)  # run lengths stay exact in f32
        and n * (K + 1) <= 2 * nnz + 4096  # padding waste bounded
    ):
        # All-ones columns (hashed text, the hot path): group values are just
        # run lengths, so the expensive global (row, index) radix sort
        # collapses to a per-row np.sort over a padded int32 matrix — an
        # order of magnitude cheaper on short rows.
        return _combine_ones_padded(indices, values, indptr, counts, K, sum_collisions)
    # One stable sort over (row, index) keys groups duplicates per row while
    # preserving original occurrence order inside each group. Integer keys
    # take numpy's radix path, so this is bandwidth- not comparison-bound.
    span = int(indices.max()) + 1
    key = np.repeat(np.arange(n, dtype=np.int64), counts) * span
    key += indices
    order = np.argsort(key, kind="stable")
    sk = key[order]
    newgrp = np.ones(nnz, dtype=bool)
    np.not_equal(sk[1:], sk[:-1], out=newgrp[1:])
    gstart = np.flatnonzero(newgrp)  # group start positions, sorted order
    n_groups = len(gstart)
    sk_g = sk[gstart]
    grp_row = sk_g // span
    idx_g = sk_g - grp_row * span
    ucounts = np.bincount(grp_row, minlength=n)
    has_dup = ucounts < counts
    if not has_dup.any():
        # fast path: nothing to combine, just trim exact zeros
        out_idx, out_val, out_counts = indices, values, counts
    else:
        # Duplicate-free rows have ucounts == counts, so the group stream IS
        # the output; they just get an original-order overwrite afterwards
        # (their groups are singletons, but sorted, not occurrence-ordered).
        out_counts = ucounts
        out_indptr = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(ucounts, out=out_indptr[1:])
        out_idx = idx_g
        if not sum_collisions:
            out_val = values[order[gstart]]  # stable sort => first occurrence
        elif all_ones:
            # each group sums to its size, exact in f32
            out_val = np.diff(np.append(gstart, nnz)).astype(np.float32)
        else:
            gid = np.cumsum(newgrp) - 1
            out_val = np.zeros(n_groups, dtype=np.float32)
            np.add.at(out_val, gid, values[order])  # f32 accumulate, like from_lists
        # duplicate-free rows: restore original entry order, O(their nnz)
        nd_rows = np.flatnonzero(~has_dup)
        c_nd = counts[nd_rows]
        tot_nd = int(c_nd.sum())
        if tot_nd:
            seg = np.arange(tot_nd, dtype=np.int64) - np.repeat(
                np.cumsum(c_nd) - c_nd, c_nd
            )
            src = np.repeat(indptr[nd_rows], c_nd) + seg
            dst = np.repeat(out_indptr[nd_rows], c_nd) + seg
            out_idx[dst] = indices[src]
            out_val[dst] = values[src]
    if np.count_nonzero(out_val) == len(out_val):
        # no exact-zero values to trim
        final_indptr = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(out_counts, out=final_indptr[1:])
        return out_idx.astype(np.int32, copy=False), out_val.astype(np.float32, copy=False), final_indptr
    keep = out_val != 0
    out_row = np.repeat(np.arange(n, dtype=np.int64), out_counts)
    final_indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(out_row[keep], minlength=n).astype(np.int64), out=final_indptr[1:])
    return out_idx[keep].astype(np.int32, copy=False), out_val[keep].astype(np.float32, copy=False), final_indptr


def dense_to_batch(dense: np.ndarray, dim: int) -> SparseBatch:
    """View a dense (N, F) matrix as a SparseBatch whose feature j is index j.
    ``dim`` must be > F; the extra tail slots are free for e.g. a bias term."""
    dense = np.asarray(dense, dtype=np.float32)
    n, f = dense.shape
    if dim <= f:
        raise ValueError(f"dim {dim} must exceed feature count {f}")
    return SparseBatch(
        indices=np.broadcast_to(np.arange(f, dtype=np.int32), (n, f)).copy(),
        values=dense,
        dim=dim,
    )


def column_to_batch(column: np.ndarray, dim: int) -> SparseBatch:
    """Interpret a sparse column as a SparseBatch. :class:`SparseRows`
    columns (already duplicate-combined by construction) pad with one
    scatter; legacy object columns of (indices, values) tuples fall back to
    the per-row ``from_lists`` assembly."""
    if isinstance(column, SparseRows):
        return SparseBatch.from_csr(
            column.indices, column.values, column.indptr, dim
        )
    idx_lists = [np.asarray(x[0]) for x in column]
    val_lists = [np.asarray(x[1]) for x in column]
    return from_lists(idx_lists, val_lists, dim)


def batch_to_column(batch: SparseBatch) -> np.ndarray:
    """Store a SparseBatch as an object column of (indices, values) tuples,
    trimming per-row padding."""
    out = np.empty(batch.num_rows, dtype=object)
    for i in range(batch.num_rows):
        mask = batch.values[i] != 0
        # keep index-0 entries only if they carry value; padding has value 0
        out[i] = (batch.indices[i][mask].copy(), batch.values[i][mask].copy())
    return out
