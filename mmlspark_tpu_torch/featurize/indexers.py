"""Categorical value indexing, the port's copy of
``mmlspark_tpu/featurize/indexers.py`` (``ValueIndexer.scala:55``,
``ValueIndexerModel:102``, ``IndexToValue.scala:27``).

Levels ride in column metadata (``{"categorical": True, "levels": [...]}``),
so one-hot assembly and ``IndexToValue`` need no side channel. An object
column is read through each value's ``str()`` (``None`` is missing, a NaN
float is the level ``"nan"``) and its levels sort in code-point order, as in
the reference; the lookups here are whole-column numpy over the distinct
strings (:func:`str_codes`), which gives the reference's indices.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np

from mmlspark_tpu_torch.core.params import HasInputCol, HasOutputCol, Param
from mmlspark_tpu_torch.core.pipeline import Estimator, Model, Transformer
from mmlspark_tpu_torch.core.schema import ColType, add_column, require_column
from mmlspark_tpu_torch.data.table import Table


def str_codes(col) -> Tuple[List[str], np.ndarray]:
    """The distinct ``str()`` of an object column's values, in first-seen
    order, and each row's index into them (-1 for ``None``)."""
    index: Dict[str, int] = {}
    codes = np.fromiter((-1 if v is None else index.setdefault(str(v), len(index)) for v in col),
                        dtype=np.int64, count=len(col))
    return list(index), codes


def lookup_str(col, levels: List[str]) -> np.ndarray:
    """``levels.index(str(v))`` per row of an object column, ``len(levels)``
    for ``None`` and for values not among the levels."""
    distinct, codes = str_codes(col)
    lookup = {v: i for i, v in enumerate(levels)}
    unknown = len(levels)
    per_value = np.array([lookup.get(s, unknown) for s in distinct] + [unknown], dtype=np.int64)
    return per_value[codes]


def _index_out_schema(stage: Any, schema: Dict[str, Any]) -> Dict[str, Any]:
    name = type(stage).__name__
    require_column(schema, stage.getInputCol(), name)
    out = stage.getOutputCol()
    return add_column(schema, out, ColType(np.dtype(np.int64), ()), name,
                      replace=out == stage.getInputCol())


def _isnan(col: np.ndarray) -> np.ndarray:
    if np.issubdtype(col.dtype, np.floating):
        return np.isnan(col)
    return np.zeros(len(col), dtype=bool)


class ValueIndexer(HasInputCol, HasOutputCol, Estimator):
    """Distinct values -> dense indices [0, n); an unseen value maps to n
    (the unknown bucket) at transform time."""

    def transform_schema(self, schema: Dict[str, Any]) -> Dict[str, Any]:
        return _index_out_schema(self, schema)

    def _fit(self, table: Table) -> "ValueIndexerModel":
        col = table.column(self.getInputCol())
        if col.dtype == object:
            levels = sorted(str_codes(col)[0])
        else:
            levels = [v.item() for v in np.unique(col[~_isnan(col)])]
        model = ValueIndexerModel(
            inputCol=self.getInputCol(), outputCol=self.getOutputCol(), levels=levels,
            dataType="string" if col.dtype == object else str(col.dtype))
        model.parent = self
        return model


class ValueIndexerModel(HasInputCol, HasOutputCol, Model):
    levels = Param("Ordered distinct values", default=[])
    dataType = Param("Original value dtype", default="string")

    def transform(self, table: Table) -> Table:
        col = table.column(self.getInputCol())
        levels = self.getLevels()
        unknown = len(levels)
        if col.dtype == object:
            out = lookup_str(col, levels)
        else:
            lookup = {v: i for i, v in enumerate(levels)}
            out = np.array([lookup.get(v.item(), unknown) for v in col], dtype=np.int64)
        return table.with_column(self.getOutputCol(), out,
                                 metadata={"categorical": True, "levels": list(levels)})

    def transform_schema(self, schema: Dict[str, Any]) -> Dict[str, Any]:
        return _index_out_schema(self, schema)


def decode_levels(indices: np.ndarray, levels: List[Any]) -> np.ndarray:
    """Indices -> the level values; the unknown bucket decodes to None
    (string levels) or NaN (numeric levels). ``IndexToValue`` and
    ``TrainedClassifierModel`` share it."""
    idx = np.asarray(indices).astype(np.int64)
    in_range = (idx >= 0) & (idx < len(levels))
    if levels and not isinstance(levels[0], str):
        values = np.asarray(levels, dtype=np.float64)
        return np.where(in_range, values[np.clip(idx, 0, len(levels) - 1)], np.nan)
    table = np.empty(len(levels) + 1, dtype=object)
    table[:-1] = levels
    return table[np.where(in_range, idx, len(levels))]


class IndexToValue(HasInputCol, HasOutputCol, Transformer):
    """ValueIndexer's inverse: an index column with categorical metadata
    back to its values (``IndexToValue.scala:27``)."""

    def transform(self, table: Table) -> Table:
        meta = table.metadata(self.getInputCol())
        if not meta.get("categorical") or "levels" not in meta:
            raise ValueError(f"column {self.getInputCol()!r} has no categorical levels metadata")
        out = decode_levels(table.column(self.getInputCol()), meta["levels"])
        return table.with_column(self.getOutputCol(), out)

    def transform_schema(self, schema: Dict[str, Any]) -> Dict[str, Any]:
        name = type(self).__name__
        require_column(schema, self.getInputCol(), name)
        out = self.getOutputCol()
        # the decoded dtype follows the levels in the column's metadata
        # (strings -> object, numbers -> float64), not the schema
        return add_column(schema, out, ColType(), name, replace=out == self.getInputCol())
