"""Columnar, immutable Table — the port's copy of
``mmlspark_tpu/data/table.py``: named columns of equal length, each a 1-D
numpy array, a 2-D fixed-width "vector" column, an object column (of per-row
``(indices, values)`` sparse tuples, say) or a
:class:`~mmlspark_tpu_torch.data.sparse.SparseRows` column, which row
selection and :meth:`Table.concat` keep sparse. Per-column metadata and the
``num_partitions`` hint ride along every derived table, as in the
reference, and a saved table keeps both.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Sequence

import numpy as np

from mmlspark_tpu_torch.data.sparse import SparseRows


def _as_column(values):
    """A numpy array (or :class:`SparseRows`) of ``values``; a list of
    equal-length sequences becomes a 2-D column, ragged ones an object
    column of their rows."""
    if isinstance(values, (np.ndarray, SparseRows)):
        return values
    if hasattr(values, "__array__"):
        return np.asarray(values)
    values = list(values)
    if values and isinstance(values[0], str):
        return np.array(values, dtype=object)
    if values and isinstance(values[0], (list, tuple, np.ndarray)):
        if len({len(v) for v in values}) == 1:
            try:
                arr = np.asarray(values)
            except ValueError:  # rows of ragged parts, as (indices, values) tuples
                arr = None
            if arr is not None and arr.dtype != object:
                return arr
        out = np.empty(len(values), dtype=object)
        for i, v in enumerate(values):
            out[i] = v
        return out
    return np.asarray(values)


class Table:
    """An immutable, ordered collection of named numpy columns of equal length."""

    __slots__ = ("_columns", "_num_rows", "_metadata", "num_partitions")

    def __init__(self, columns: Mapping[str, np.ndarray],
                 metadata: Optional[Dict[str, Dict[str, Any]]] = None, num_partitions: int = 1):
        cols: Dict[str, np.ndarray] = {}
        n = None
        for name, values in columns.items():
            arr = _as_column(values)
            if n is None:
                n = len(arr)
            elif len(arr) != n:
                raise ValueError(f"column {name!r} has length {len(arr)}, expected {n}")
            cols[name] = arr
        self._columns = cols
        self._num_rows = n or 0
        self._metadata = dict(metadata or {})
        self.num_partitions = max(1, int(num_partitions))

    def _derive(self, columns: Dict[str, np.ndarray],
                metadata: Optional[Dict[str, Dict[str, Any]]] = None) -> "Table":
        """A table of ``columns`` that keeps this one's metadata (unless
        given) and partition hint."""
        t = Table.__new__(Table)
        t._columns = columns
        t._num_rows = len(next(iter(columns.values()))) if columns else 0
        t._metadata = dict(self._metadata) if metadata is None else metadata
        t.num_partitions = self.num_partitions
        return t

    @property
    def columns(self) -> List[str]:
        return list(self._columns)

    @property
    def num_rows(self) -> int:
        return self._num_rows

    def __len__(self) -> int:
        return self._num_rows

    def __contains__(self, name: str) -> bool:
        return name in self._columns

    def __getitem__(self, name: str) -> np.ndarray:
        return self.column(name)

    def column(self, name: str) -> np.ndarray:
        if name not in self._columns:
            raise KeyError(f"no column {name!r}; available: {sorted(self._columns)}")
        return self._columns[name]

    def metadata(self, name: str) -> Dict[str, Any]:
        return self._metadata.get(name, {})

    def with_column(self, name: str, values, metadata: Optional[Dict[str, Any]] = None
                    ) -> "Table":
        arr = _as_column(values)
        if self._columns and len(arr) != self._num_rows:
            raise ValueError(
                f"column {name!r} has length {len(arr)}, expected {self._num_rows}"
            )
        meta = dict(self._metadata)
        if metadata is not None:
            meta[name] = metadata
        return self._derive({**self._columns, name: arr}, meta)

    def with_columns(self, updates: Mapping[str, Any]) -> "Table":
        out = self
        for k, v in updates.items():
            out = out.with_column(k, v)
        return out

    def filter(self, mask) -> "Table":
        """The rows where ``mask`` is true, in order."""
        mask = np.asarray(mask, dtype=bool)
        return self._derive({k: v[mask] for k, v in self._columns.items()})

    def sort_by(self, name: str, ascending: bool = True) -> "Table":
        """Stable sort by one column (ties keep row order, both directions)."""
        col = self.column(name)
        if ascending:
            order = np.argsort(col, kind="stable")
        else:
            # stable ascending argsort of the reversed column, mapped back
            # to the original rows, then reversed
            n = len(col)
            order = (n - 1 - np.argsort(col[::-1], kind="stable"))[::-1]
        return self._derive({k: v[order] for k, v in self._columns.items()})

    @staticmethod
    def concat(tables: Sequence["Table"]) -> "Table":
        """The rows of ``tables`` one after another; sparse columns stay
        :class:`SparseRows` where every part is one."""
        tables = [t for t in tables if t.num_rows > 0] or list(tables[:1])
        if not tables:
            return Table({})
        cols = {}
        for name in tables[0].columns:
            parts = [t.column(name) for t in tables]
            if all(isinstance(p, SparseRows) for p in parts):
                cols[name] = SparseRows.concat(parts)
                continue
            parts = [p.to_object_column() if isinstance(p, SparseRows) else p for p in parts]
            if any(p.dtype == object for p in parts):
                merged = np.empty(sum(len(p) for p in parts), dtype=object)
                i = 0
                for p in parts:
                    for row in p:  # element-wise: each row keeps its payload
                        merged[i] = row
                        i += 1
                cols[name] = merged
            else:
                cols[name] = np.concatenate(parts)
        return Table(cols, metadata=dict(tables[0]._metadata),
                     num_partitions=tables[0].num_partitions)

    def to_dict(self) -> Dict[str, np.ndarray]:
        return dict(self._columns)

    def __repr__(self) -> str:
        parts = ", ".join(
            f"{k}: {v.dtype}{list(v.shape[1:]) if v.ndim > 1 else ''}"
            for k, v in self._columns.items()
        )
        return f"Table[{self._num_rows} rows, {self.num_partitions} partitions]({parts})"
