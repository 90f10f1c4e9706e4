"""Featurize: heterogeneous columns to one dense feature matrix, the port's
copy of ``mmlspark_tpu/featurize/featurize.py`` (``Featurize.scala:25``,
``AssembleFeatures.scala:96-467``).

Per column: numerics imputed with their mean, strings one-hot encoded (or
indexed) when they are few and repeat, hashed as text otherwise, vectors
passed through; then one float32 matrix. String columns are read through
each value's ``str()``, as in the reference, and are looked up and hashed
once per distinct value, then gathered to the rows
(:func:`~mmlspark_tpu_torch.featurize.indexers.str_codes`).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from mmlspark_tpu_torch.core.params import (
    HasInputCols,
    HasOutputCol,
    Param,
    gt,
    to_bool,
    to_int,
    to_str,
)
from mmlspark_tpu_torch.core.pipeline import Estimator, Model, Transformer
from mmlspark_tpu_torch.core.schema import (
    DTYPE_MISMATCH,
    ColType,
    SchemaError,
    add_column,
    require_column,
)
from mmlspark_tpu_torch.data.table import Table
from mmlspark_tpu_torch.featurize.indexers import lookup_str, str_codes
from mmlspark_tpu_torch.featurize.text import hashing_tf


def _is_numeric(col: np.ndarray) -> bool:
    return col.ndim == 1 and np.issubdtype(col.dtype, np.number) or col.dtype == bool


class AssembleFeatures(HasInputCols, HasOutputCol, Transformer):
    """Concatenate numeric and vector columns into one 2-D features column
    (``FastVectorAssembler``'s role)."""

    outputCol = Param("Assembled features column", default="features", converter=to_str)

    def transform(self, table: Table) -> Table:
        blocks: List[np.ndarray] = []
        for name in self.getInputCols():
            col = table.column(name)
            if col.ndim == 2:
                blocks.append(col.astype(np.float32))
            elif col.dtype == object:
                blocks.append(np.stack([np.asarray(v, dtype=np.float32) for v in col]))
            elif col.dtype == bool or np.issubdtype(col.dtype, np.number):
                blocks.append(col.astype(np.float32)[:, None])
            else:
                raise ValueError(f"column {name!r} (dtype {col.dtype}) is not assemblable; "
                                 "index or hash it first")
        return table.with_column(self.getOutputCol(), np.hstack(blocks))

    def transform_schema(self, schema: Dict[str, Any]) -> Dict[str, Any]:
        name = type(self).__name__
        width: Optional[int] = 0
        for c in self.getInputCols():
            col = require_column(schema, c, name, numeric=False)
            if col.dtype is not None and col.dtype.kind in "US":
                raise SchemaError(DTYPE_MISMATCH, f"column {c!r} (dtype {col.dtype}) is not "
                                  "assemblable; index or hash it first", stage=name, column=c)
            if width is not None and col.shape is not None:
                width += col.shape[0] if col.shape else 1
            else:
                width = None  # an input of unknown width: the total is unknown
        out = self.getOutputCol()
        return add_column(schema, out,
                          ColType(np.dtype(np.float32), (width,) if width is not None else None),
                          name, replace=out in set(self.getInputCols()))


class Featurize(HasInputCols, HasOutputCol, Estimator):
    """Auto-featurizer: imputes numerics, one-hot (or index) encodes
    low-cardinality strings, hashes free text, passes vectors through, and
    assembles everything into ``outputCol``."""

    outputCol = Param("Features column", default="features", converter=to_str)
    oneHotEncodeCategoricals = Param("One-hot (true) vs single index column (false)",
                                     default=True, converter=to_bool)
    numberOfFeatures = Param("Hash dimensions for text columns (power of two)", default=1 << 8,
                             converter=to_int, validator=gt(0))
    allowImages = Param("Kept for parity", default=False, converter=to_bool)

    _MAX_CATEGORICAL_CARDINALITY = 100

    def transform_schema(self, schema: Dict[str, Any]) -> Dict[str, Any]:
        name = type(self).__name__
        for c in self.getInputCols():
            require_column(schema, c, name)
        out = self.getOutputCol()
        # the width follows the fitted plans (one-hot cardinalities): unknown
        return add_column(schema, out, ColType(np.dtype(np.float32)), name,
                          replace=out in set(self.getInputCols()))

    def _fit(self, table: Table) -> "FeaturizeModel":
        plans: List[Dict[str, Any]] = []
        for name in self.getInputCols():
            col = table.column(name)
            if col.ndim == 2 or (col.dtype == object and len(col)
                                 and isinstance(col[0], (list, np.ndarray))):
                plans.append({"kind": "vector", "col": name})
            elif _is_numeric(col):
                values = col.astype(np.float64)
                valid = values[~np.isnan(values)]
                plans.append({"kind": "numeric", "col": name,
                              "fill": float(valid.mean()) if len(valid) else 0.0})
            else:
                distinct, codes = str_codes(col)
                n_values = int((codes >= 0).sum())
                # strings that are few and repeat are categories; near-unique
                # ones are free text, hashed
                if len(distinct) <= self._MAX_CATEGORICAL_CARDINALITY and (
                        n_values < 2 or len(distinct) <= max(2, n_values // 2)):
                    plans.append({"kind": "categorical", "col": name, "levels": sorted(distinct)})
                else:
                    plans.append({"kind": "text", "col": name})
        model = FeaturizeModel(outputCol=self.getOutputCol(), plans=plans,
                               oneHotEncodeCategoricals=self.getOneHotEncodeCategoricals(),
                               numberOfFeatures=self.getNumberOfFeatures())
        model.parent = self
        return model


class FeaturizeModel(HasOutputCol, Model):
    plans = Param("Per-column featurization plans", default=[])
    oneHotEncodeCategoricals = Param("One-hot categoricals", default=True, converter=to_bool)
    numberOfFeatures = Param("Text hash dimensions", default=1 << 8, converter=to_int)

    def transform_schema(self, schema: Dict[str, Any]) -> Dict[str, Any]:
        name = type(self).__name__
        width: Optional[int] = 0
        for plan in self.getPlans():
            col = require_column(schema, plan["col"], name)
            kind = plan["kind"]
            if kind == "numeric":
                w: Optional[int] = 1
            elif kind == "categorical":
                w = len(plan["levels"]) + 1 if self.getOneHotEncodeCategoricals() else 1
            elif kind == "text":
                w = self.getNumberOfFeatures()
            else:  # a vector: the input column's width, if known
                w = col.shape[0] if col.shape else None
            width = width + w if (width is not None and w is not None) else None
        out = self.getOutputCol()
        return add_column(schema, out,
                          ColType(np.dtype(np.float32), (width,) if width is not None else None),
                          name, replace=out in {p["col"] for p in self.getPlans()})

    def _block(self, plan: Dict[str, Any], col: np.ndarray) -> np.ndarray:
        kind = plan["kind"]
        if kind == "vector":
            if col.ndim == 2:
                return col.astype(np.float32)
            return np.stack([np.asarray(v, dtype=np.float32) for v in col])
        if kind == "numeric":
            values = col.astype(np.float64)
            return np.where(np.isnan(values), plan["fill"], values).astype(np.float32)[:, None]
        if kind == "categorical":
            levels: List[str] = plan["levels"]
            idx = lookup_str(col, levels)
            if not self.getOneHotEncodeCategoricals():
                return idx.astype(np.float32)[:, None]
            onehot = np.zeros((len(col), len(levels) + 1), dtype=np.float32)
            onehot[np.arange(len(col)), idx] = 1.0
            return onehot
        if kind == "text":
            # one document per distinct string, and the empty one for None
            distinct, codes = str_codes(col)
            tf = hashing_tf([s.lower().split() for s in distinct] + [[]],
                            self.getNumberOfFeatures())
            return tf[codes]
        raise ValueError(f"unknown plan kind {kind!r}")

    def transform(self, table: Table) -> Table:
        blocks = [self._block(plan, table.column(plan["col"])) for plan in self.getPlans()]
        return table.with_column(self.getOutputCol(), np.hstack(blocks))
