"""Column type conversion, the port's copy of
``mmlspark_tpu/featurize/conversion.py`` (``DataConversion.scala:21``)."""

from __future__ import annotations

import datetime
from typing import Dict

import numpy as np

from mmlspark_tpu_torch.core.params import HasInputCols, Param, one_of, to_str
from mmlspark_tpu_torch.core.pipeline import Transformer
from mmlspark_tpu_torch.data.table import Table

_DTYPES: Dict[str, np.dtype] = {
    "boolean": np.dtype(bool),
    "byte": np.dtype(np.int8),
    "short": np.dtype(np.int16),
    "integer": np.dtype(np.int32),
    "long": np.dtype(np.int64),
    "float": np.dtype(np.float32),
    "double": np.dtype(np.float64),
    "string": np.dtype(object),
    "toCategorical": np.dtype(object),  # indexed, below
    "clearCategorical": np.dtype(object),  # decoded, below
    "date": np.dtype("datetime64[ms]"),
}


class DataConversion(HasInputCols, Transformer):
    """Cast the listed columns to ``convertTo``; ``toCategorical`` indexes a
    column in place (ValueIndexer), ``clearCategorical`` decodes it back."""

    convertTo = Param("Target type", default="double", converter=to_str,
                      validator=one_of(*_DTYPES))
    dateTimeFormat = Param("strptime format for string->date", default=None)

    def transform(self, table: Table) -> Table:
        from mmlspark_tpu_torch.featurize.indexers import IndexToValue, ValueIndexer

        target = self.getConvertTo()
        out = table
        for name in self.getInputCols():
            col = table.column(name)
            if target == "toCategorical":
                out = ValueIndexer(inputCol=name, outputCol=name).fit(out).transform(out)
            elif target == "clearCategorical":
                out = IndexToValue(inputCol=name, outputCol=name).transform(out)
                out = out.with_metadata(name, {})
            elif target == "string":
                out = out.with_column(name, np.array([str(v) for v in col], dtype=object))
            elif target == "date":
                fmt = self.getDateTimeFormat()
                if fmt:
                    converted = np.array([
                        np.datetime64(datetime.datetime.strptime(str(v), fmt), "ms")
                        for v in col])
                else:
                    converted = col.astype("datetime64[ms]")
                out = out.with_column(name, converted)
            elif target == "boolean":
                out = out.with_column(name, col.astype(np.float64) != 0)
            else:
                out = out.with_column(name, col.astype(_DTYPES[target]))
        return out
