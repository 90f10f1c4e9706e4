"""Columnar, immutable Table — the port's copy of
``mmlspark_tpu/data/table.py``: named columns of equal length, each a 1-D
numpy array, a 2-D fixed-width "vector" column, an object column (of per-row
``(indices, values)`` sparse tuples, say) or a
:class:`~mmlspark_tpu_torch.data.sparse.SparseRows` column, which row
selection and :meth:`Table.concat` keep sparse. Per-column metadata and the
``num_partitions`` hint ride along every derived table, as in the
reference, and a saved table keeps both. Explicit partition sizes
(:meth:`Table.with_partition_sizes`) survive only derivations that keep the
row count; otherwise :meth:`Table.partition_bounds` splits the rows evenly.
``from_pandas`` and ``to_pandas`` import pandas when called.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Mapping, Optional, Sequence, Tuple

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

    __slots__ = ("_columns", "_num_rows", "_metadata", "num_partitions", "_partition_sizes")

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
        self._partition_sizes: Optional[List[int]] = None

    def _derive(self, columns: Dict[str, np.ndarray],
                metadata: Optional[Dict[str, Dict[str, Any]]] = None) -> "Table":
        """A table of ``columns`` that keeps this one's metadata (unless
        given) and partition hint; pinned partition sizes only when the row
        count is kept."""
        t = Table.__new__(Table)
        t._columns = columns
        t._num_rows = len(next(iter(columns.values()))) if columns else 0
        t._metadata = dict(self._metadata) if metadata is None else metadata
        t.num_partitions = self.num_partitions
        t._partition_sizes = self._partition_sizes if t._num_rows == self._num_rows else None
        return t

    @staticmethod
    def from_pandas(df: Any, num_partitions: int = 1) -> "Table":
        """A table of a pandas DataFrame's columns; object columns stay
        object arrays."""
        cols = {}
        for name in df.columns:
            s = df[name]
            cols[name] = s.to_numpy(dtype=object) if s.dtype == object else s.to_numpy()
        return Table(cols, num_partitions=num_partitions)

    @staticmethod
    def from_rows(rows: Sequence[Mapping[str, Any]], num_partitions: int = 1) -> "Table":
        """A table of row dicts, columns named by the first row's keys."""
        if not rows:
            return Table({})
        names = list(rows[0].keys())
        return Table({n: [r[n] for r in rows] for n in names}, num_partitions=num_partitions)

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

    @property
    def schema(self) -> Dict[str, np.dtype]:
        return {k: v.dtype for k, v in self._columns.items()}

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

    def with_metadata(self, name: str, metadata: Dict[str, Any]) -> "Table":
        return self._derive(dict(self._columns), {**self._metadata, name: metadata})

    def select(self, *names: str) -> "Table":
        missing = [n for n in names if n not in self._columns]
        if missing:
            raise KeyError(f"no columns {missing}; available: {sorted(self._columns)}")
        return self._derive({n: self._columns[n] for n in names})

    def drop(self, *names: str) -> "Table":
        return self._derive({k: v for k, v in self._columns.items() if k not in set(names)})

    def rename(self, old: str, new: str) -> "Table":
        if old not in self._columns:
            raise KeyError(old)
        cols = {(new if k == old else k): v for k, v in self._columns.items()}
        meta = dict(self._metadata)
        if old in meta:
            meta[new] = meta.pop(old)
        return self._derive(cols, meta)

    def filter(self, mask) -> "Table":
        """The rows where ``mask`` is true, in order."""
        mask = np.asarray(mask, dtype=bool)
        return self._derive({k: v[mask] for k, v in self._columns.items()})

    def take(self, indices) -> "Table":
        idx = np.asarray(indices)
        return self._derive({k: v[idx] for k, v in self._columns.items()})

    def head(self, n: int = 5) -> "Table":
        return self._derive({k: v[:n] for k, v in self._columns.items()})

    def slice(self, start: int, stop: int) -> "Table":
        return self._derive({k: v[start:stop] for k, v in self._columns.items()})

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
        return self.take(order)

    def sample(self, fraction: float, seed: int = 0) -> "Table":
        """Each row kept with probability ``fraction``: the reference's rows
        for the same seed (one ``default_rng(seed).random`` draw a row)."""
        rng = np.random.default_rng(seed)
        return self.filter(rng.random(self._num_rows) < fraction)

    def random_split(self, weights: Sequence[float], seed: int = 0) -> List["Table"]:
        """Rows dealt into ``len(weights)`` tables by one seeded
        ``choice`` draw a row, in proportion to the weights."""
        rng = np.random.default_rng(seed)
        w = np.asarray(weights, dtype=float)
        assignment = rng.choice(len(w), size=self._num_rows, p=w / w.sum())
        return [self.filter(assignment == i) for i in range(len(w))]

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

    def repartition(self, n: int) -> "Table":
        out = self._derive(dict(self._columns))
        out.num_partitions = max(1, int(n))
        out._partition_sizes = None
        return out

    def with_partition_sizes(self, sizes: Sequence[int]) -> "Table":
        """Pin contiguous partition sizes (they must sum to ``num_rows``),
        as partition-aware stages such as ``StratifiedRepartition`` do."""
        sizes = [int(s) for s in sizes]
        if sum(sizes) != self._num_rows:
            raise ValueError(f"partition sizes {sizes} sum to {sum(sizes)}, "
                             f"expected {self._num_rows}")
        out = self._derive(dict(self._columns))
        out.num_partitions = len(sizes)
        out._partition_sizes = sizes
        return out

    def coalesce(self, n: int) -> "Table":
        return self.repartition(min(self.num_partitions, n))

    def partition_bounds(self) -> List[Tuple[int, int]]:
        """Row ranges of the logical partitions: the pinned sizes, else an
        even contiguous split."""
        if self._partition_sizes is not None:
            edges = np.concatenate([[0], np.cumsum(self._partition_sizes)])
        else:
            edges = np.linspace(0, self._num_rows, self.num_partitions + 1).astype(int)
        return [(int(edges[i]), int(edges[i + 1])) for i in range(len(edges) - 1)]

    def partitions(self) -> Iterator["Table"]:
        for lo, hi in self.partition_bounds():
            yield self.slice(lo, hi)

    def to_pandas(self) -> Any:
        import pandas as pd

        return pd.DataFrame({k: list(v) if (v.ndim > 1 or isinstance(v, SparseRows)) else v
                             for k, v in self._columns.items()})

    def to_dict(self) -> Dict[str, np.ndarray]:
        return dict(self._columns)

    def rows(self) -> Iterator[Dict[str, Any]]:
        names = self.columns
        for i in range(self._num_rows):
            yield {n: self._columns[n][i] for n in names}

    def __repr__(self) -> str:
        parts = ", ".join(
            f"{k}: {v.dtype}{list(v.shape[1:]) if v.ndim > 1 else ''}"
            for k, v in self._columns.items()
        )
        return f"Table[{self._num_rows} rows, {self.num_partitions} partitions]({parts})"


def row_as_json_dict(table: Table, row: int, exclude: Sequence[str] = ()) -> Dict[str, Any]:
    """One row as a JSON-serializable dict (an array to a list, a numpy
    scalar to a Python one), the converter REST writers share."""
    out: Dict[str, Any] = {}
    for name in table.columns:
        if name in exclude:
            continue
        v = table.column(name)[row]
        if isinstance(v, np.ndarray):
            v = v.tolist()
        elif isinstance(v, np.generic):
            v = v.item()
        out[name] = v
    return out


def find_unused_column_name(prefix: str, table: Table) -> str:
    """``prefix``, or ``prefix_<i>`` for the first ``i`` not taken in
    ``table`` (``DatasetExtensions.findUnusedColumnName``)."""
    name = prefix
    i = 1
    while name in table:
        name = f"{prefix}_{i}"
        i += 1
    return name
