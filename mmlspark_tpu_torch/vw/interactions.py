"""VowpalWabbitInteractions — quadratic feature crossing between namespaces.

The port's copy of ``mmlspark_tpu/vw/interactions.py`` (host numpy, the
same indices and values bit for bit). Parity with
``vw/VowpalWabbitInteractions.scala``: given sparse feature
columns (namespaces), emit the crossed features — index = VW-style
hash-combine of the member indices, value = product of member values.

Crossing is column-vectorized like the featurizer: each input column is
duplicate-combined and zero-trimmed once (``combine_csr``), then the
a-major pair expansion for every row happens in one flat gather — pair t of
row r reads member ``t // |b_r|`` of the left namespace and ``t % |b_r|``
of the right — with no per-row Python. Output is a :class:`SparseRows` CSR
column, feature-space identical to the original per-row implementation.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from mmlspark_tpu_torch.core.params import (
    HasInputCols,
    HasOutputCol,
    Param,
    in_range,
    to_bool,
    to_int,
)
from mmlspark_tpu_torch.core.pipeline import Transformer
from mmlspark_tpu_torch.data.sparse import SparseRows, combine_csr
from mmlspark_tpu_torch.data.table import Table

# VW's FNV-style hash-combine multiplier used when crossing namespaces.
_INTERACTION_MULT = np.uint32(0x5BD1E995)


def combine_hashes(a: np.ndarray, b: np.ndarray, num_bits: int) -> np.ndarray:
    with np.errstate(over="ignore"):
        h = (a.astype(np.uint32) * _INTERACTION_MULT) ^ b.astype(np.uint32)
        return (h & np.uint32((1 << num_bits) - 1)).astype(np.int32)


def _as_csr(col) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Any sparse column (SparseRows or legacy tuple objects) as flat CSR."""
    if isinstance(col, SparseRows):
        return col.indices.astype(np.int64), col.values, col.indptr
    idx = [np.asarray(x[0], dtype=np.int64) for x in col]
    val = [np.asarray(x[1], dtype=np.float32) for x in col]
    counts = np.fromiter(map(len, idx), dtype=np.int64, count=len(idx))
    indptr = np.zeros(len(idx) + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    return (
        np.concatenate(idx) if idx else np.zeros(0, dtype=np.int64),
        np.concatenate(val) if val else np.zeros(0, dtype=np.float32),
        indptr,
    )


def _cross_csr(
    ai: np.ndarray, av: np.ndarray, ap: np.ndarray,
    bi: np.ndarray, bv: np.ndarray, bp: np.ndarray,
    num_bits: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Row-wise a-major cross product of two CSR namespaces: one gather per
    side, |a_r| * |b_r| pairs per row, index = hash-combine, value = product."""
    n = len(ap) - 1
    ca, cb = np.diff(ap), np.diff(bp)
    m = ca * cb
    optr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(m, out=optr[1:])
    M = int(optr[-1])
    rows = np.repeat(np.arange(n, dtype=np.int64), m)
    t = np.arange(M, dtype=np.int64) - optr[rows]
    cbr = cb[rows]
    a_pos = ap[rows] + t // cbr
    b_pos = bp[rows] + t % cbr
    ci = combine_hashes(ai[a_pos], bi[b_pos], num_bits).astype(np.int64)
    return ci, av[a_pos] * bv[b_pos], optr


class VowpalWabbitInteractions(HasInputCols, HasOutputCol, Transformer):
    numBits = Param("log2 feature-space size", default=18, converter=to_int, validator=in_range(1, 30))
    sumCollisions = Param("Sum values on hash collisions", default=True, converter=to_bool)

    def transform(self, table: Table) -> Table:
        cols = self.getInputCols()
        if len(cols) < 2:
            raise ValueError("interactions need at least two input columns")
        num_bits = self.getNumBits()
        dim = 1 << num_bits
        # Each input namespace is duplicate-combined (summed, as the padded
        # batches always were) and zero-trimmed BEFORE crossing; intermediate
        # cross products are never re-filtered, matching the original.
        csrs = [combine_csr(*_as_csr(table.column(c))) for c in cols]
        ci, cv, cp = csrs[0]
        ci = ci.astype(np.int64)
        for bi, bv, bp in csrs[1:]:
            ci, cv, cp = _cross_csr(ci, cv, cp, bi.astype(np.int64), bv, bp, num_bits)
        fi, fv, fp = combine_csr(ci, cv, cp, self.getSumCollisions())
        return table.with_column(
            self.getOutputCol(),
            SparseRows(fi, fv, fp, dim),
            metadata={"sparse_dim": dim},
        )
