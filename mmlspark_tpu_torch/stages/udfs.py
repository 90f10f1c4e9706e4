"""Column helper functions, the port's copy of ``mmlspark_tpu/stages/udfs.py``
(``stages/udfs.scala:16``): whole columns instead of per-row Spark UDFs."""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np


def get_value_at(col: np.ndarray, index: int) -> np.ndarray:
    """Element ``index`` of each vector in a vector column
    (``udfs.get_value_at``)."""
    if col.dtype == object:
        return np.array([np.asarray(v, dtype=np.float64)[index] for v in col])
    return col[:, index].astype(np.float64)


def to_vector(col: Sequence[Any]) -> np.ndarray:
    """Array/list column -> fixed-width vector column (``udfs.to_vector``)."""
    arr = np.asarray([np.asarray(v, dtype=np.float64) for v in col])
    return arr
