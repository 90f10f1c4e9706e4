"""Mini-batching transformers, the port's copy of
``mmlspark_tpu/stages/batching.py`` (``stages/MiniBatchTransformer.scala:43-174``,
``stages/Batchers.scala:12-131``).

In the reference these amortize JNI dispatch: rows are grouped so that one
native call evaluates many rows. On the card the same batching amortizes
kernel launches: a model turns each batched row into one device step. A
batched Table column is an object array whose elements are the per-batch
arrays (ragged in the last batch); each batch formed publishes
``BatchFormed`` on the event bus.

The reference's background-thread iterator machinery (`Batchers.scala`)
disappears: batching a columnar Table is pure slicing.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np

from mmlspark_tpu_torch.core.params import Param, gt, to_bool, to_int
from mmlspark_tpu_torch.core.pipeline import Transformer
from mmlspark_tpu_torch.core.schema import ColType, require_column
from mmlspark_tpu_torch.data.table import Table


def _batch_bounds(n: int, sizes: List[int]) -> List[tuple]:
    bounds, lo = [], 0
    i = 0
    while lo < n:
        size = sizes[min(i, len(sizes) - 1)]
        bounds.append((lo, min(lo + size, n)))
        lo += size
        i += 1
    return bounds


class _MiniBatchBase(Transformer):
    """Shared schema rule for the batchers: every column keeps its name but
    becomes an object column whose elements are the per-batch arrays."""

    def transform_schema(self, schema: Dict[str, Any]) -> Dict[str, Any]:
        return {name: ColType(np.dtype(object)) for name in schema}


def _batch_table(table: Table, bounds: List[tuple]) -> Table:
    from mmlspark_tpu_torch.observability.events import BatchFormed, get_bus

    cols: Dict[str, np.ndarray] = {}
    for name in table.columns:
        col = table.column(name)
        out = np.empty(len(bounds), dtype=object)
        for i, (lo, hi) in enumerate(bounds):
            out[i] = col[lo:hi]
        cols[name] = out
    bus = get_bus()
    if bus.active:
        for i, (lo, hi) in enumerate(bounds):
            bus.publish(BatchFormed(epoch=i, size=hi - lo))
    batched = Table(cols)
    batched.num_partitions = table.num_partitions
    return batched


class FixedMiniBatchTransformer(_MiniBatchBase):
    """Group every ``batchSize`` consecutive rows into one batch row
    (``stages/MiniBatchTransformer.scala:139``)."""

    batchSize = Param("Rows per batch", default=10, converter=to_int, validator=gt(0))
    maxBufferSize = Param(
        "Kept for parity; columnar batching needs no buffer", default=-1,
        converter=to_int,
    )
    buffered = Param("Kept for parity (background buffering thread)",
                     default=False, converter=to_bool)

    def transform(self, table: Table) -> Table:
        return _batch_table(
            table, _batch_bounds(table.num_rows, [self.getBatchSize()])
        )


class DynamicMiniBatchTransformer(_MiniBatchBase):
    """Batch whatever is available, up to ``maxBatchSize``
    (``stages/MiniBatchTransformer.scala:43``). Without a streaming queue the
    whole partition is 'available': each logical partition becomes one batch,
    capped at ``maxBatchSize`` rows."""

    maxBatchSize = Param(
        "Maximum rows per batch", default=2**31 - 1, converter=to_int, validator=gt(0)
    )

    def transform(self, table: Table) -> Table:
        cap = self.getMaxBatchSize()
        bounds: List[tuple] = []
        for lo, hi in table.partition_bounds():
            while lo < hi:
                bounds.append((lo, min(lo + cap, hi)))
                lo += cap
        return _batch_table(table, bounds)


class TimeIntervalMiniBatchTransformer(_MiniBatchBase):
    """Batch rows arriving within ``millisToWait`` of each other
    (``stages/MiniBatchTransformer.scala:95``). Materialized Tables have no
    arrival times; an explicit ``timestampCol`` (epoch millis) partitions rows
    into interval-gap batches, else one batch per partition."""

    millisToWait = Param(
        "Interval in milliseconds", default=1000, converter=to_int, validator=gt(0)
    )
    maxBatchSize = Param(
        "Maximum rows per batch", default=2**31 - 1, converter=to_int, validator=gt(0)
    )
    timestampCol = Param("Optional epoch-millis column defining arrival times",
                         default=None)

    def transform_schema(self, schema: Dict[str, Any]) -> Dict[str, Any]:
        ts_col = self.getTimestampCol()
        if ts_col is not None:
            require_column(schema, ts_col, type(self).__name__, numeric=True)
        return super().transform_schema(schema)

    def transform(self, table: Table) -> Table:
        cap = self.getMaxBatchSize()
        ts_col = self.getTimestampCol()
        bounds: List[tuple] = []
        if ts_col is not None:
            ts = table.column(ts_col).astype(np.int64)
            lo = 0
            for i in range(1, table.num_rows + 1):
                boundary = (
                    i == table.num_rows
                    or ts[i] - ts[i - 1] > self.getMillisToWait()
                    or i - lo >= cap
                )
                if boundary:
                    bounds.append((lo, i))
                    lo = i
        else:
            for lo, hi in table.partition_bounds():
                while lo < hi:
                    bounds.append((lo, min(lo + cap, hi)))
                    lo += cap
        return _batch_table(table, bounds)


class FlattenBatch(Transformer):
    """Invert mini-batching: explode every batched column back to one row per
    element (``stages/MiniBatchTransformer.scala:159``)."""

    def transform_schema(self, schema: Dict[str, Any]) -> Dict[str, Any]:
        # batched (object) columns re-flatten to their element dtype, which
        # is data-dependent; non-object columns are repeated unchanged
        out: Dict[str, Any] = {}
        for name, col in schema.items():
            dtype = getattr(col, "dtype", None)
            out[name] = ColType() if dtype == np.dtype(object) else col
        return out

    def transform(self, table: Table) -> Table:
        if table.num_rows == 0:
            return table
        lengths = None
        for name in table.columns:
            col = table.column(name)
            if col.dtype == object:
                lens = np.array([len(v) for v in col], dtype=np.int64)
                if lengths is None:
                    lengths = lens
                elif not np.array_equal(lengths, lens):
                    raise ValueError(
                        f"batched column {name!r} lengths disagree with other columns"
                    )
        if lengths is None:
            raise ValueError("no batched (object) columns to flatten")
        cols: Dict[str, Any] = {}
        for name in table.columns:
            col = table.column(name)
            if col.dtype == object:
                parts = [np.asarray(v) for v in col]
                if any(p.dtype == object or p.ndim == 0 for p in parts):
                    flat: List[Any] = []
                    for v in col:
                        flat.extend(list(v))
                    cols[name] = flat
                else:
                    cols[name] = np.concatenate(parts)
            else:
                cols[name] = np.repeat(col, lengths, axis=0)
        out = Table(cols)
        out.num_partitions = table.num_partitions
        return out
