"""Column and row stages, the port's copy of ``mmlspark_tpu/stages/basic.py``
(the reference's ``stages/``, SURVEY.md section 2.11).

Each class is one reference transformer over the columnar Table: row-wise
UDF loops become whole-column numpy, and Spark repartitioning becomes the
Table's logical partition hint, which the mesh's data shards read.
"""

from __future__ import annotations

import logging
import time
import unicodedata
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from mmlspark_tpu_torch.core.params import (
    HasInputCol,
    HasInputCols,
    HasLabelCol,
    HasOutputCol,
    HasOutputCols,
    Param,
    ge,
    gt,
    one_of,
    to_bool,
    to_int,
    to_list_str,
    to_str,
)
from mmlspark_tpu_torch.core.pipeline import Estimator, Model, Transformer
from mmlspark_tpu_torch.core.schema import ColType, add_column, require_column
from mmlspark_tpu_torch.data.table import Table

logger = logging.getLogger("mmlspark_tpu_torch.stages")


class Cacher(Transformer):
    """Materialization point (``stages/Cacher.scala``). Tables are already
    host-materialized, so this is an explicit no-op kept for pipeline parity."""

    disable = Param("If true, do not cache", default=False, converter=to_bool)

    def transform(self, table: Table) -> Table:
        return table


class DropColumns(Transformer):
    """Drop the listed columns (``stages/DropColumns.scala``)."""

    cols = Param("Columns to remove", converter=to_list_str)

    def transform(self, table: Table) -> Table:
        for c in self.getCols():
            table.column(c)  # raise on missing, like the reference's verifySchema
        return table.drop(*self.getCols())

    def transform_schema(self, schema: Dict[str, Any]) -> Dict[str, Any]:
        name = type(self).__name__
        for c in self.getCols():
            require_column(schema, c, name)
        return {k: v for k, v in schema.items() if k not in set(self.getCols())}


class SelectColumns(Transformer):
    """Keep only the listed columns (``stages/SelectColumns.scala``)."""

    cols = Param("Columns to keep", converter=to_list_str)

    def transform(self, table: Table) -> Table:
        return table.select(*self.getCols())

    def transform_schema(self, schema: Dict[str, Any]) -> Dict[str, Any]:
        name = type(self).__name__
        return {
            c: require_column(schema, c, name) for c in self.getCols()
        }


class RenameColumn(Transformer):
    """Rename ``inputCol`` to ``outputCol`` (``stages/RenameColumn.scala``)."""

    inputCol = Param("Column to rename", converter=to_str)
    outputCol = Param("New column name", converter=to_str)

    def transform(self, table: Table) -> Table:
        return table.rename(self.getInputCol(), self.getOutputCol())

    def transform_schema(self, schema: Dict[str, Any]) -> Dict[str, Any]:
        name = type(self).__name__
        src, dst = self.getInputCol(), self.getOutputCol()
        col = require_column(schema, src, name)
        rest = {k: v for k, v in schema.items() if k != src}
        return add_column(rest, dst, col, name)


class Repartition(Transformer):
    """Change the logical partition count (``stages/Repartition.scala``).

    Partitions map rows onto mesh data-parallel shards
    (`Table.partition_bounds`), standing in for Spark partitions feeding
    `ClusterUtil`-derived worker counts."""

    n = Param("Number of partitions", converter=to_int, validator=gt(0))
    disable = Param("If true, pass through unchanged", default=False, converter=to_bool)

    def transform(self, table: Table) -> Table:
        if self.getDisable():
            return table
        return table.repartition(self.getN())


class StratifiedRepartition(HasLabelCol, Transformer):
    """Rebalance rows so every partition sees every label value
    (``stages/StratifiedRepartition.scala:29``).

    The reference re-keys rows round-robin within each label and invokes a
    range partitioner; with contiguous Table partitions the equivalent is a
    label-round-robin row ordering: rows of each label are dealt one at a
    time across partitions, guaranteeing each contiguous shard holds an
    (almost) proportional slice of every label — which is what keeps
    per-device GBDT histograms from collapsing to single-class."""

    mode = Param(
        "equal, original, or mixed distribution of labels",
        default="mixed",
        converter=to_str,
        validator=one_of("equal", "original", "mixed"),
    )
    seed = Param("Random seed", default=0, converter=to_int)

    def transform_schema(self, schema: Dict[str, Any]) -> Dict[str, Any]:
        require_column(schema, self.getLabelCol(), type(self).__name__)
        return dict(schema)

    def transform(self, table: Table) -> Table:
        if table.num_rows == 0:
            return table
        labels = table.column(self.getLabelCol()).astype(str)
        nparts = table.num_partitions
        rng = np.random.default_rng(self.getSeed())
        values, counts = np.unique(labels, return_counts=True)
        # Per-label resampling fraction (sampleByKeyExact-with-replacement
        # analogue, StratifiedRepartition.scala:48-58,70-73).
        max_count = max(int(counts.max()), nparts)
        mode = self.getMode()
        if mode == "equal":
            fractions = max_count / counts
        elif mode == "original":
            fractions = np.ones(len(values))
        else:  # mixed heuristic: partial upsampling toward equal
            fractions = np.sqrt(max_count / counts)
        # Resample each label, split its rows into nparts near-even chunks,
        # and give chunk p to partition p — every partition receives a slice
        # of every label (whenever a label has ≥ nparts rows). The resulting
        # per-partition sizes are pinned on the Table so partition_bounds
        # reflects the actual groups (RangePartitioner's role).
        per_part: List[List[np.ndarray]] = [[] for _ in range(nparts)]
        for val, frac in zip(values, fractions):
            idx = np.flatnonzero(labels == val)
            target = max(1, int(round(len(idx) * frac)))
            if target > len(idx):
                idx = np.concatenate([idx, rng.choice(idx, target - len(idx))])
            rng.shuffle(idx)
            for p, chunk in enumerate(np.array_split(idx, nparts)):
                per_part[p].append(chunk)
        part_rows = [np.concatenate(chunks) for chunks in per_part]
        out = table.take(np.concatenate(part_rows))
        return out.with_partition_sizes([len(r) for r in part_rows])


class ClassBalancer(HasInputCol, HasOutputCol, Estimator):
    """Adds a weight column inversely proportional to label frequency
    (``stages/ClassBalancer.scala:27``)."""

    outputCol = Param("Weight column name", default="weight", converter=to_str)
    broadcastJoin = Param(
        "Whether to broadcast the weight table (no-op hint here)",
        default=True,
        converter=to_bool,
    )

    def transform_schema(self, schema: Dict[str, Any]) -> Dict[str, Any]:
        return _weight_col_schema(self, schema)

    def _fit(self, table: Table) -> "ClassBalancerModel":
        col = table.column(self.getInputCol())
        values, counts = np.unique(col.astype(str), return_counts=True)
        weights = counts.max() / counts.astype(np.float64)
        model = ClassBalancerModel(
            inputCol=self.getInputCol(),
            outputCol=self.getOutputCol(),
            weights={str(v): float(w) for v, w in zip(values, weights)},
        )
        model.parent = self
        return model


class ClassBalancerModel(HasInputCol, HasOutputCol, Model):
    weights = Param("label value -> weight", default={})

    def transform(self, table: Table) -> Table:
        col = table.column(self.getInputCol()).astype(str)
        w = self.getWeights()
        out = np.array([w.get(v, 1.0) for v in col], dtype=np.float64)
        return table.with_column(self.getOutputCol(), out)

    def transform_schema(self, schema: Dict[str, Any]) -> Dict[str, Any]:
        return _weight_col_schema(self, schema)


def _weight_col_schema(
    stage: Any, schema: Dict[str, Any]
) -> Dict[str, Any]:
    name = type(stage).__name__
    require_column(schema, stage.getInputCol(), name)
    out = stage.getOutputCol()
    return add_column(
        schema,
        out,
        ColType(np.dtype(np.float64), ()),
        name,
        replace=out == stage.getInputCol(),
    )


class Explode(HasInputCol, HasOutputCol, Transformer):
    """One output row per element of a ragged/list column
    (``stages/Explode.scala``); other columns are repeated."""

    def transform(self, table: Table) -> Table:
        col = table.column(self.getInputCol())
        out_name = self.getOutputCol() if self.isDefined("outputCol") else self.getInputCol()
        lengths = np.array([len(v) for v in col], dtype=np.int64)
        repeat_idx = np.repeat(np.arange(table.num_rows), lengths)
        flat: List[Any] = []
        for v in col:
            flat.extend(list(v))
        base = table.drop(self.getInputCol()).take(repeat_idx)
        return base.with_column(out_name, flat)

    def transform_schema(self, schema: Dict[str, Any]) -> Dict[str, Any]:
        name = type(self).__name__
        src = self.getInputCol()
        require_column(schema, src, name)
        out = self.getOutputCol() if self.isDefined("outputCol") else src
        rest = {k: v for k, v in schema.items() if k != src}
        # element dtype of a ragged column is data-dependent -> unknown
        return add_column(rest, out, ColType(), name)


class Lambda(Transformer):
    """Arbitrary ``Table -> Table`` function as a pipeline stage
    (``stages/Lambda.scala:21``). The function is a complex param
    (pickle-serialized), like the reference's UDF ComplexParam."""

    transformFunc = Param("Table -> Table function", is_complex=True)
    transformSchemaFunc = Param(
        "schema -> schema function (optional)", default=None, is_complex=True
    )

    def transform(self, table: Table) -> Table:
        return self.getTransformFunc()(table)

    def transform_schema(self, schema: Dict[str, Any]) -> Dict[str, Any]:
        f = self.getTransformSchemaFunc()
        return f(schema) if f is not None else dict(schema)


class UDFTransformer(HasInputCol, HasInputCols, HasOutputCol, Transformer):
    """Applies a column function to one or many input columns
    (``stages/UDFTransformer.scala``). ``udf`` receives whole column
    arrays (vectorized), not scalar rows."""

    udf = Param("Column-level function", is_complex=True)

    def transform(self, table: Table) -> Table:
        f = self.getUdf()
        if self.isDefined("inputCols") and self.isSet("inputCols"):
            args = [table.column(c) for c in self.getInputCols()]
        else:
            args = [table.column(self.getInputCol())]
        return table.with_column(self.getOutputCol(), f(*args))

    def transform_schema(self, schema: Dict[str, Any]) -> Dict[str, Any]:
        name = type(self).__name__
        if self.isDefined("inputCols") and self.isSet("inputCols"):
            ins = list(self.getInputCols())
        else:
            ins = [self.getInputCol()]
        for c in ins:
            require_column(schema, c, name)
        out = self.getOutputCol()
        # the udf's output dtype is opaque to static analysis
        return add_column(schema, out, ColType(), name, replace=out in ins)


class MultiColumnAdapter(HasInputCols, HasOutputCols, Transformer, Estimator):
    """Map a single-column stage over many column pairs
    (``stages/MultiColumnAdapter.scala:18``)."""

    baseStage = Param("Stage to replicate per column", is_complex=True)

    def _pairs(self) -> List[tuple]:
        ins, outs = self.getInputCols(), self.getOutputCols()
        if len(ins) != len(outs):
            raise ValueError(
                f"inputCols ({len(ins)}) and outputCols ({len(outs)}) must align"
            )
        return list(zip(ins, outs))

    def _stage_for(self, in_col: str, out_col: str):
        stage = self.getBaseStage().copy()
        stage.set("inputCol", in_col)
        stage.set("outputCol", out_col)
        return stage

    def transform(self, table: Table) -> Table:
        for in_col, out_col in self._pairs():
            table = self._stage_for(in_col, out_col).transform(table)
        return table

    def transform_schema(self, schema: Dict[str, Any]) -> Dict[str, Any]:
        for in_col, out_col in self._pairs():
            schema = self._stage_for(in_col, out_col).transform_schema(schema)
        return schema

    def _fit(self, table: Table) -> Model:
        from mmlspark_tpu_torch.core.pipeline import PipelineModel

        fitted: List[Transformer] = []
        cur = table
        for in_col, out_col in self._pairs():
            stage = self._stage_for(in_col, out_col)
            if isinstance(stage, Estimator):
                m = stage.fit(cur)
            else:
                m = stage
            cur = m.transform(cur)
            fitted.append(m)
        model = PipelineModel(stages=fitted)
        model.parent = self
        return model


class TextPreprocessor(HasInputCol, HasOutputCol, Transformer):
    """Trie-based substring mapping (``stages/TextPreprocessor.scala:96``):
    longest-match replacement of every ``map`` key found in the text."""

    map = Param("substring -> replacement", default={})
    normFunc = Param(
        "Normalization applied before matching: identity|lowerCase|upperCase",
        default="identity",
        converter=to_str,
        validator=one_of("identity", "lowerCase", "upperCase"),
    )

    # Per-character case mapping (Java Character.toLowerCase semantics):
    # chars whose case-fold changes length (e.g. 'İ') are left as-is so
    # match offsets on the normalized text stay valid in the original.
    @staticmethod
    def _char_map(s: str, f: Callable[[str], str]) -> str:
        return "".join(c2 if len(c2 := f(c)) == 1 else c for c in s)

    _NORM_FUNCS = {
        "identity": lambda s: s,
        "lowerCase": lambda s: TextPreprocessor._char_map(s, str.lower),
        "upperCase": lambda s: TextPreprocessor._char_map(s, str.upper),
    }

    def transform(self, table: Table) -> Table:
        import re

        norm = self._NORM_FUNCS[self.getNormFunc()]
        # Keys are normalized at build time, like the reference Trie inserts
        # normFunc-mapped keys (TextPreprocessor.scala:29-38); matching runs
        # on the normalized text but unmatched spans keep their original form
        # (Trie.mapText appends the original chars).
        mapping = {norm(k): v for k, v in self.getMap().items()}
        col = table.column(self.getInputCol())
        if mapping:
            # Longest-first alternation == greedy trie longest-match.
            pattern = re.compile(
                "|".join(re.escape(k) for k in sorted(mapping, key=len, reverse=True))
            )

            def apply(s: str) -> str:
                normed = norm(s)
                out, pos = [], 0
                for m in pattern.finditer(normed):
                    out.append(s[pos : m.start()])
                    out.append(mapping[m.group(0)])
                    pos = m.end()
                out.append(s[pos:])
                return "".join(out)
        else:
            def apply(s: str) -> str:
                return s
        out = np.array([apply(str(s)) for s in col], dtype=object)
        return table.with_column(self.getOutputCol(), out)

    def transform_schema(self, schema: Dict[str, Any]) -> Dict[str, Any]:
        return _text_out_schema(self, schema)


class UnicodeNormalize(HasInputCol, HasOutputCol, Transformer):
    """Unicode NFKD/NFC normalization + optional lower-casing
    (``stages/UnicodeNormalize.scala``)."""

    form = Param(
        "Normalization form", default="NFKD", converter=to_str,
        validator=one_of("NFC", "NFD", "NFKC", "NFKD"),
    )
    lower = Param("Lower-case the text", default=True, converter=to_bool)

    def transform(self, table: Table) -> Table:
        col = table.column(self.getInputCol())
        form = self.getForm()
        lower = self.getLower()

        def norm(s: Any) -> Any:
            if s is None:
                return None
            s = unicodedata.normalize(form, str(s))
            return s.lower() if lower else s

        out = np.array([norm(s) for s in col], dtype=object)
        return table.with_column(self.getOutputCol(), out)

    def transform_schema(self, schema: Dict[str, Any]) -> Dict[str, Any]:
        return _text_out_schema(self, schema)


def _text_out_schema(stage: Any, schema: Dict[str, Any]) -> Dict[str, Any]:
    """input col must exist; output is a fresh object (string) column,
    overwriting in place when outputCol == inputCol."""
    name = type(stage).__name__
    src = stage.getInputCol()
    require_column(schema, src, name)
    out = stage.getOutputCol()
    return add_column(
        schema, out, ColType(np.dtype(object)), name, replace=out == src
    )


class Timer(Estimator):
    """Wraps a stage; logs fit/transform wall time (``stages/Timer.scala:57``).

    The driver-side timing of the reference; pair with
    ``mmlspark_tpu_torch.core.utils.StopWatch`` for finer phases and with
    ``torch.profiler`` for traces of the card (SURVEY.md section 5)."""

    stage = Param("The wrapped stage", is_complex=True)
    logToScala = Param("Log with the framework logger", default=True, converter=to_bool)
    disableMaterialization = Param(
        "Kept for reference parity; Tables are always materialized",
        default=True,
        converter=to_bool,
    )

    def transform_schema(self, schema: Dict[str, Any]) -> Dict[str, Any]:
        return self.getStage().transform_schema(schema)

    def _log(self, msg: str) -> str:
        if self.getLogToScala():
            logger.info(msg)
        return msg

    def fit(self, table: Table, params: Optional[Dict[str, Any]] = None) -> Model:
        if params:
            return self.copy(params).fit(table)
        stage = self.getStage()
        if isinstance(stage, Estimator):
            t0 = time.perf_counter()
            inner = stage.fit(table)
            self._log(
                f"{type(stage).__name__}.fit took {time.perf_counter() - t0:.3f}s"
            )
        else:
            inner = stage
        model = TimerModel(stage=inner, logToScala=self.getLogToScala())
        model.parent = self
        return model

    def _fit(self, table: Table) -> Model:
        return self.fit(table)

    def transform(self, table: Table) -> Table:
        # Transformer-style use: time the wrapped transformer directly.
        return self.fit(table).transform(table)


class TimerModel(Model):
    stage = Param("The wrapped fitted stage", is_complex=True)
    logToScala = Param("Log with the framework logger", default=True, converter=to_bool)

    def transform(self, table: Table) -> Table:
        stage = self.getStage()
        t0 = time.perf_counter()
        out = stage.transform(table)
        msg = f"{type(stage).__name__}.transform took {time.perf_counter() - t0:.3f}s"
        if self.getLogToScala():
            logger.info(msg)
        return out


class EnsembleByKey(Transformer):
    """Aggregate scalar/vector columns grouped by key columns
    (``stages/EnsembleByKey.scala:22``)."""

    keys = Param("Grouping key columns", converter=to_list_str)
    cols = Param("Columns to aggregate", converter=to_list_str)
    colNames = Param("Output names (default: '<strategy>(<col>)')", converter=to_list_str)
    strategy = Param(
        "Aggregation strategy", default="mean", converter=to_str, validator=one_of("mean")
    )
    collapseGroup = Param(
        "If true, one row per key; else broadcast the aggregate back to all rows",
        default=True,
        converter=to_bool,
    )
    vectorDims = Param("Kept for parity; dims inferred from data", default=None)

    def transform(self, table: Table) -> Table:
        keys, cols = self.getKeys(), self.getCols()
        if self.isDefined("colNames") and self.isSet("colNames"):
            names = self.getColNames()
        else:
            names = [f"{self.getStrategy()}({c})" for c in cols]
        key_arrays = [table.column(k) for k in keys]
        composite = np.array(
            ["\x00".join(str(a[i]) for a in key_arrays) for i in range(table.num_rows)]
        )
        uniq, first_idx, inverse = np.unique(
            composite, return_index=True, return_inverse=True
        )
        agg: Dict[str, np.ndarray] = {}
        for c, name in zip(cols, names):
            col = table.column(c)
            dense = np.stack([np.asarray(v, dtype=np.float64) for v in col]) \
                if col.dtype == object else col.astype(np.float64)
            if dense.ndim == 1:
                sums = np.zeros(len(uniq))
                np.add.at(sums, inverse, dense)
            else:
                sums = np.zeros((len(uniq),) + dense.shape[1:])
                np.add.at(sums, inverse, dense)
            counts = np.bincount(inverse, minlength=len(uniq)).astype(np.float64)
            agg[name] = sums / counts.reshape((-1,) + (1,) * (sums.ndim - 1))
        if self.getCollapseGroup():
            out = table.select(*keys).take(first_idx)
            for name, values in agg.items():
                out = out.with_column(name, values)
            return out
        out = table
        for name, values in agg.items():
            out = out.with_column(name, values[inverse])
        return out


class SummarizeData(Transformer):
    """Per-column summary statistics table (``stages/SummarizeData.scala:100``):
    counts, missing, basic moments, and error-bounded quantiles."""

    counts = Param("Include count stats", default=True, converter=to_bool)
    basic = Param("Include basic stats", default=True, converter=to_bool)
    sample = Param("Include sample stats", default=True, converter=to_bool)
    percentiles = Param("Include percentiles", default=True, converter=to_bool)
    errorThreshold = Param(
        "Quantile error (0 = exact)", default=0.0, validator=ge(0.0)
    )

    _PERCENTILES = [0.005, 0.01, 0.05, 0.25, 0.5, 0.75, 0.95, 0.99, 0.995]

    def transform(self, table: Table) -> Table:
        rows: List[Dict[str, Any]] = []
        n = table.num_rows
        for name in table.columns:
            col = table.column(name)
            row: Dict[str, Any] = {"Feature": name}
            is_numeric = col.ndim == 1 and np.issubdtype(col.dtype, np.number)
            if col.dtype == object:
                missing = sum(1 for v in col if v is None)
            elif np.issubdtype(col.dtype, np.floating):
                missing = int(np.isnan(col).sum())
            else:
                missing = 0
            if self.getCounts():
                row["Count"] = float(n)
                row["Unique Value Count"] = float(len(np.unique(col.astype(str))) if col.ndim == 1 else n)
                row["Missing Value Count"] = float(missing)
            if is_numeric:
                valid = col[~np.isnan(col.astype(np.float64))].astype(np.float64)
                if self.getBasic():
                    row["Max"] = float(valid.max()) if len(valid) else np.nan
                    row["Min"] = float(valid.min()) if len(valid) else np.nan
                    row["Mean"] = float(valid.mean()) if len(valid) else np.nan
                if self.getSample():
                    row["Sample Variance"] = (
                        float(valid.var(ddof=1)) if len(valid) > 1 else np.nan
                    )
                    row["Sample Standard Deviation"] = (
                        float(valid.std(ddof=1)) if len(valid) > 1 else np.nan
                    )
                if self.getPercentiles():
                    for p in self._PERCENTILES:
                        row[f"Quantile {p}"] = (
                            float(np.quantile(valid, p)) if len(valid) else np.nan
                        )
            rows.append(row)
        all_keys: List[str] = []
        for r in rows:
            for k in r:
                if k not in all_keys:
                    all_keys.append(k)
        cols = {
            k: np.array(
                [r.get(k, np.nan) for r in rows],
                dtype=object if k == "Feature" else np.float64,
            )
            for k in all_keys
        }
        return Table(cols)
