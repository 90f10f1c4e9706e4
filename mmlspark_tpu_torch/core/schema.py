"""Static pipeline schemas — the port's copy of ``mmlspark_tpu/core/schema.py``,
the ``transformSchema`` half of the analysis layer.

SparkML pipelines are validated before execution: every stage implements
``transformSchema(schema: StructType)`` and ``Pipeline.fit`` threads the
DataFrame schema through the whole stage graph up front, so a mis-wired
pipeline fails in milliseconds on the driver instead of minutes into a
cluster job. This module is that contract for :class:`Table` pipelines —
the stakes are higher here, because the first ``transform`` typically
triggers a compile or a device launch.

A schema is a plain ``Dict[str, ColType]``: column name to dtype plus the
optional per-row element shape (vector columns are 2-D in a Table; their
``shape`` is ``(width,)`` when known, ``None`` when data-dependent).
``ColType(None, None)`` means "column exists, nothing else known" — every
check treats unknown as compatible, so partial knowledge propagates
without false alarms.

Stage authors use the helpers (:func:`require_column`, :func:`add_column`)
inside ``transform_schema`` overrides; errors are :class:`SchemaError`
with a structured ``kind`` (``missing-input-col`` / ``dtype-mismatch`` /
``duplicate-output-col``) and the offending stage + column, so tests and
tools can assert on semantics rather than message strings.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np

# Structured error kinds (stable API — tests match on these).
MISSING_INPUT_COL = "missing-input-col"
DTYPE_MISMATCH = "dtype-mismatch"
DUPLICATE_OUTPUT_COL = "duplicate-output-col"


@dataclasses.dataclass(frozen=True)
class ColType:
    """Static type of one column: numpy dtype (None = unknown) and the
    per-row element shape (() = scalar column, ``(w,)`` = width-w vector,
    None = unknown/ragged)."""

    dtype: Optional[np.dtype] = None
    shape: Optional[Tuple[int, ...]] = None

    def __repr__(self) -> str:  # compact in error messages
        d = self.dtype if self.dtype is not None else "?"
        if self.shape is None:
            return f"ColType({d})"
        return f"ColType({d}, shape={self.shape})"


class SchemaError(ValueError):
    """A statically-detected pipeline wiring error."""

    def __init__(
        self,
        kind: str,
        message: str,
        stage: Optional[str] = None,
        column: Optional[str] = None,
    ):
        self.kind = kind
        self.stage = stage
        self.column = column
        self.bare_message = message
        prefix = f"[{kind}]"
        if stage:
            prefix += f" stage {stage}:"
        super().__init__(f"{prefix} {message}")

    def with_stage(self, stage: str) -> "SchemaError":
        """Re-tag with the pipeline-level stage label (index + class)."""
        return SchemaError(self.kind, self.bare_message, stage, self.column)


def as_schema(source: Any) -> Dict[str, ColType]:
    """Normalize a Table / ``{name: dtype}`` / ``{name: ColType}`` mapping
    into a ``{name: ColType}`` schema."""
    from mmlspark_tpu_torch.data.table import Table

    if isinstance(source, Table):
        return schema_of_table(source)
    out: Dict[str, ColType] = {}
    for name, value in dict(source).items():
        if isinstance(value, ColType):
            out[name] = value
        elif value is None:
            out[name] = ColType()
        else:
            out[name] = ColType(dtype=np.dtype(value))
    return out


def schema_of_table(table: Any) -> Dict[str, ColType]:
    """Schema of a concrete Table: dtypes from the columns, element shapes
    from ndim (2-D columns are width-``shape[1]`` vectors; object columns
    have unknown element shape)."""
    out: Dict[str, ColType] = {}
    for name in table.columns:
        col = table.column(name)
        dtype = col.dtype
        if dtype == np.dtype(object):
            out[name] = ColType(dtype=dtype, shape=None)
        elif col.ndim >= 2:
            out[name] = ColType(dtype=dtype, shape=tuple(col.shape[1:]))
        else:
            out[name] = ColType(dtype=dtype, shape=())
    return out


def _is_numeric(dtype: np.dtype) -> bool:
    return np.issubdtype(dtype, np.number) or np.issubdtype(dtype, np.bool_)


def require_column(
    schema: Dict[str, ColType],
    column: str,
    stage: str,
    dtype: Any = None,
    numeric: bool = False,
) -> ColType:
    """Assert ``column`` exists (and optionally has a compatible dtype).
    Unknown dtypes always pass — the validator reports what it can prove
    wrong, not what it cannot prove right."""
    if column not in schema:
        have = ", ".join(sorted(schema)) or "<empty>"
        raise SchemaError(
            MISSING_INPUT_COL,
            f"input column {column!r} not found (have: {have})",
            stage=stage,
            column=column,
        )
    col = schema[column]
    if col.dtype is None:
        return col
    if numeric and not _is_numeric(col.dtype) and col.dtype != np.dtype(object):
        raise SchemaError(
            DTYPE_MISMATCH,
            f"column {column!r} must be numeric, found {col.dtype}",
            stage=stage,
            column=column,
        )
    if dtype is not None and col.dtype != np.dtype(object):
        want = np.dtype(dtype)
        if col.dtype != want and not np.can_cast(col.dtype, want):
            raise SchemaError(
                DTYPE_MISMATCH,
                f"column {column!r} has dtype {col.dtype}, expected {want}",
                stage=stage,
                column=column,
            )
    return col


def add_column(
    schema: Dict[str, ColType],
    column: str,
    coltype: ColType,
    stage: str,
    replace: bool = False,
) -> Dict[str, ColType]:
    """Return ``schema`` + the stage's output column. ``replace=True`` is
    for stages whose contract overwrites in place (e.g. in-col == out-col
    transforms); otherwise an existing name is a wiring error."""
    if column in schema and not replace:
        raise SchemaError(
            DUPLICATE_OUTPUT_COL,
            f"output column {column!r} already exists",
            stage=stage,
            column=column,
        )
    out = dict(schema)
    out[column] = coltype
    return out
