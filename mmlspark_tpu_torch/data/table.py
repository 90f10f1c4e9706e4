"""Columnar, immutable Table — the port's minimal copy of
``mmlspark_tpu/data/table.py``: named numpy columns of equal length (1-D, or
2-D fixed-width "vector" columns). Sparse and ragged columns are not ported.
"""

from __future__ import annotations

from typing import Dict, List, Mapping

import numpy as np


class Table:
    """An immutable, ordered collection of named numpy columns of equal length."""

    __slots__ = ("_columns", "_num_rows")

    def __init__(self, columns: Mapping[str, np.ndarray]):
        cols: Dict[str, np.ndarray] = {}
        n = None
        for name, values in columns.items():
            arr = np.asarray(values)
            if n is None:
                n = len(arr)
            elif len(arr) != n:
                raise ValueError(f"column {name!r} has length {len(arr)}, expected {n}")
            cols[name] = arr
        self._columns = cols
        self._num_rows = n or 0

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

    def with_column(self, name: str, values) -> "Table":
        arr = np.asarray(values)
        if self._columns and len(arr) != self._num_rows:
            raise ValueError(
                f"column {name!r} has length {len(arr)}, expected {self._num_rows}"
            )
        return Table({**self._columns, name: arr})

    def filter(self, mask) -> "Table":
        """The rows where ``mask`` is true, in order."""
        mask = np.asarray(mask, dtype=bool)
        return Table({k: v[mask] for k, v in self._columns.items()})

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
        return Table({k: v[order] for k, v in self._columns.items()})

    def __repr__(self) -> str:
        parts = ", ".join(
            f"{k}: {v.dtype}{list(v.shape[1:]) if v.ndim > 1 else ''}"
            for k, v in self._columns.items()
        )
        return f"Table[{self._num_rows} rows]({parts})"
