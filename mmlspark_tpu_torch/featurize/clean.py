"""Missing-value imputation, the port's copy of
``mmlspark_tpu/featurize/clean.py`` (``CleanMissingData.scala:49``)."""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from mmlspark_tpu_torch.core.params import HasInputCols, HasOutputCols, Param, one_of, to_str
from mmlspark_tpu_torch.core.pipeline import Estimator, Model
from mmlspark_tpu_torch.core.schema import ColType, add_column, require_column
from mmlspark_tpu_torch.data.table import Table


def _clean_out_schema(stage: Any, schema: Dict[str, Any]) -> Dict[str, Any]:
    """Each input column must exist; each output column holds the imputed
    values (float64 for a numeric input, the input's own dtype otherwise)."""
    name = type(stage).__name__
    ins = list(stage.getInputCols())
    outs = list(stage.getOutputCols()) if stage.isSet("outputCols") else ins
    if len(ins) != len(outs):
        raise ValueError(f"inputCols ({len(ins)}) and outputCols ({len(outs)}) must align")
    for in_col, out_col in zip(ins, outs):
        col = require_column(schema, in_col, name)
        if col.dtype is not None and col.dtype != np.dtype(object):
            col = ColType(np.dtype(np.float64), col.shape)
        schema = add_column(schema, out_col, col, name, replace=out_col == in_col)
    return schema


class CleanMissingData(HasInputCols, HasOutputCols, Estimator):
    """Replace NaN/None with the mean, the median or a custom value per column."""

    cleaningMode = Param("Mean, Median, or Custom", default="Mean", converter=to_str,
                         validator=one_of("Mean", "Median", "Custom"))
    customValue = Param("Replacement when cleaningMode=Custom", default=None)

    def transform_schema(self, schema: Dict[str, Any]) -> Dict[str, Any]:
        return _clean_out_schema(self, schema)

    def _fit(self, table: Table) -> "CleanMissingDataModel":
        mode = self.getCleaningMode()
        fills: Dict[str, Any] = {}
        for col_name in self.getInputCols():
            col = table.column(col_name)
            if col.dtype == object:
                if mode != "Custom":
                    raise ValueError(
                        f"column {col_name!r} is non-numeric; use cleaningMode='Custom'")
                fills[col_name] = self.getCustomValue()
                continue
            values = col.astype(np.float64)
            valid = values[~np.isnan(values)]
            if mode == "Mean":
                fills[col_name] = float(valid.mean()) if len(valid) else 0.0
            elif mode == "Median":
                fills[col_name] = float(np.median(valid)) if len(valid) else 0.0
            else:
                fills[col_name] = float(self.getCustomValue())
        model = CleanMissingDataModel(
            inputCols=self.getInputCols(),
            outputCols=self.getOutputCols() if self.isSet("outputCols") else self.getInputCols(),
            fillValues=fills)
        model.parent = self
        return model


class CleanMissingDataModel(HasInputCols, HasOutputCols, Model):
    fillValues = Param("column -> replacement value", default={})

    def transform_schema(self, schema: Dict[str, Any]) -> Dict[str, Any]:
        return _clean_out_schema(self, schema)

    def transform(self, table: Table) -> Table:
        fills = self.getFillValues()
        out = table
        for in_col, out_col in zip(self.getInputCols(), self.getOutputCols()):
            col = table.column(in_col)
            fill = fills[in_col]
            if col.dtype == object:
                new = np.array([fill if v is None else v for v in col], dtype=object)
            else:
                values = col.astype(np.float64)
                new = np.where(np.isnan(values), fill, values)
            out = out.with_column(out_col, new)
        return out
