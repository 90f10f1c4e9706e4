"""Pipeline stage contracts: Transformer / Estimator / Pipeline / Evaluator —
the port's copy of ``mmlspark_tpu/core/pipeline.py`` over
:class:`~mmlspark_tpu_torch.data.table.Table`.

Stages save and load in the reference's on-disk layout
(:mod:`~mmlspark_tpu_torch.core.serialize`), so a stage saved by either
package loads in the other. ``Pipeline.fit`` publishes ``StageStarted``,
``StageCompleted``, ``ModelCommitted`` and ``RecordsDeadLettered`` on the
event bus and opens a ``fit:<stage>`` span per stage; ``PipelineModel``
opens ``transform:<stage>`` spans inside an ambient one, as the reference
does. With ``MMLSPARK_TPU_QUALITY_STORE`` set, ``Pipeline.fit`` commits a
reference profile of the training columns and scores next to the model
version, and ``PipelineModel.transform`` feeds the drift monitor
(:mod:`~mmlspark_tpu_torch.observability.quality`).
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from typing import Any, Dict, List, Optional

from mmlspark_tpu_torch.core.params import Param, Params
from mmlspark_tpu_torch.data.table import Table

# pipeline-fit ids for the event log; process-global so concurrent fits
# don't collide
_FIT_IDS = itertools.count()
_FIT_ID_LOCK = threading.Lock()


def _next_fit_id() -> int:
    with _FIT_ID_LOCK:
        return next(_FIT_IDS)


_TRACER = None


def _tracer():
    # cached process-global tracer: PipelineModel.transform is the scoring
    # hot path and must not pay import-machinery cost per call
    global _TRACER
    if _TRACER is None:
        from mmlspark_tpu_torch.observability.tracing import get_tracer

        _TRACER = get_tracer()
    return _TRACER


_GET_QMONITOR = None


def _quality_monitor():
    # same ambient-gate pattern as _tracer: the accessor is cached so an
    # unconfigured transform pays one env lookup, and the quality plane
    # only materializes when MMLSPARK_TPU_QUALITY_STORE is set
    global _GET_QMONITOR
    if _GET_QMONITOR is None:
        from mmlspark_tpu_torch.observability.quality import get_monitor

        _GET_QMONITOR = get_monitor
    return _GET_QMONITOR()


class PipelineStage(Params):
    """Base of all stages. Adds persistence (save/load)."""

    def transform_schema(self, schema: Dict[str, Any]) -> Dict[str, Any]:
        """Best-effort schema propagation; stages may override."""
        return dict(schema)

    def save(self, path: str, overwrite: bool = True) -> None:
        from mmlspark_tpu_torch.core import serialize

        serialize.save_stage(self, path, overwrite=overwrite)

    @classmethod
    def load(cls, path: str) -> "PipelineStage":
        from mmlspark_tpu_torch.core import serialize

        stage = serialize.load_stage(path)
        if cls is not PipelineStage and not isinstance(stage, cls):
            raise TypeError(f"loaded {type(stage).__name__}, expected {cls.__name__}")
        return stage

    def _save_extra(self, path: str) -> None:
        """Hook for non-param state (e.g. fitted model arrays)."""

    def _load_extra(self, path: str) -> None:
        pass


class Transformer(PipelineStage):
    def transform(self, table: Table) -> Table:
        raise NotImplementedError

    def __call__(self, table: Table) -> Table:
        return self.transform(table)


class Estimator(PipelineStage):
    def fit(self, table: Table, params: Optional[Dict[str, Any]] = None) -> "Model":
        if params:
            return self.copy(params)._fit(table)
        return self._fit(table)

    def _fit(self, table: Table) -> "Model":
        raise NotImplementedError


class Model(Transformer):
    """A fitted Transformer produced by an Estimator."""

    parent: Optional[Estimator] = None


class Evaluator(Params):
    """Computes a scalar metric from a transformed table (SparkML
    ``Evaluator`` shape)."""

    def evaluate(self, table: Table) -> float:
        raise NotImplementedError

    def is_larger_better(self) -> bool:
        return True


class Pipeline(Estimator):
    """Chain of stages; Estimators are fitted in sequence, Transformers pass
    through — SparkML ``Pipeline.fit``, with the up-front
    ``transformSchema`` pass: :meth:`validate` threads the column schema
    through every stage before anything runs, so a mis-wired graph fails
    before any data moves to the card.

    ``invalidDataPolicy`` arms the fit guard: with ``"fail"``, ``"drop"``
    or ``"impute"``, every float column is scanned for NaN/Inf (and the
    label column of a classifier stage for domain violations) before any
    stage runs — see :mod:`mmlspark_tpu_torch.dataguard.guards`. The
    default ``""`` skips the scan."""

    stages = Param("The chain of pipeline stages", default=[], is_complex=True)
    invalidDataPolicy = Param(
        "NaN/Inf/label-domain handling at fit: '' (no scan), 'fail', "
        "'drop', or 'impute'",
        default="",
    )

    def validate(self, table_or_schema: Any) -> Dict[str, Any]:
        """Statically propagate a schema (or a Table's schema) through the
        stage graph WITHOUT executing any stage. Returns the output schema;
        raises :class:`~mmlspark_tpu_torch.core.schema.SchemaError` naming
        the offending stage on the first wiring error."""
        return _chain_schema(self.getStages(), table_or_schema)

    def transform_schema(self, schema: Dict[str, Any]) -> Dict[str, Any]:
        return _chain_schema(self.getStages(), schema)

    def _fit(self, table: Table) -> "PipelineModel":
        from mmlspark_tpu_torch.observability.events import (
            ModelCommitted, StageCompleted, StageStarted, get_bus,
        )

        self.validate(table)
        bus, tracer = get_bus(), _tracer()
        fit_id = _next_fit_id()
        stages = self.getStages()
        policy = self.getInvalidDataPolicy()
        if policy:
            from mmlspark_tpu_torch.dataguard.guards import guard_table
            from mmlspark_tpu_torch.observability.events import RecordsDeadLettered

            label_col, label_domain = _label_contract(stages)
            table, report = guard_table(
                table, policy=policy, label_col=label_col,
                label_domain=label_domain, name=f"pipeline.fit:{fit_id}",
            )
            if report.rows_dropped and bus.active:
                bus.publish(RecordsDeadLettered(
                    source="pipeline.fit", epoch=fit_id,
                    count=report.rows_dropped, reasons=report.summary(),
                ))
        fitted: List[Transformer] = []
        cur = table
        for i, stage in enumerate(stages):
            name = type(stage).__name__
            if bus.active:
                bus.publish(StageStarted(job_id=fit_id, stage_id=i, name=name, phase="fit"))
            t0 = time.monotonic()
            status = "ok"
            try:
                with tracer.span(f"fit:{name}", stage=i):
                    if isinstance(stage, Estimator):
                        model = stage.fit(cur)
                        fitted.append(model)
                        if i < len(stages) - 1:
                            cur = model.transform(cur)
                    elif isinstance(stage, Transformer):
                        fitted.append(stage)
                        if i < len(stages) - 1:
                            cur = stage.transform(cur)
                    else:
                        raise TypeError(
                            f"stage {stage!r} is neither Estimator nor Transformer")
            except BaseException as e:
                status = type(e).__name__
                raise
            finally:
                if bus.active:
                    bus.publish(StageCompleted(
                        job_id=fit_id, stage_id=i, name=name,
                        duration=time.monotonic() - t0, phase="fit", status=status,
                    ))
        model = PipelineModel(stages=fitted)
        model.parent = self
        if bus.active:
            bus.publish(ModelCommitted(
                model=type(model).__name__, version=fit_id, detail=f"{len(fitted)} stages",
            ))
        # quality plane (env-gated): profile the training columns + the
        # fitted scores and commit the reference artifact next to the
        # model version, so live scoring has something to drift against
        if os.environ.get("MMLSPARK_TPU_QUALITY_STORE"):
            from mmlspark_tpu_torch.observability.quality import capture_pipeline_reference

            capture_pipeline_reference(model, table, version_hint=fit_id)
        return model


class PipelineModel(Model):
    stages = Param("The fitted pipeline stages", default=[], is_complex=True)

    def transform(self, table: Table) -> Table:
        # stage spans open only when an ambient span exists to join (a fit
        # span, an explicit tracer.span(...) around the call): a bare
        # untraced transform pays one contextvar read. The quality gate is
        # the same posture: one env lookup when unconfigured.
        monitor = _quality_monitor()
        observe = monitor is not None and not monitor.transform_suppressed
        if observe:
            in_cols = set(table.columns)
            monitor.observe_columns({c: table.column(c) for c in in_cols})
        tracer = _tracer()
        if tracer.current() is None:
            for stage in self.getStages():
                table = stage.transform(table)
        else:
            for i, stage in enumerate(self.getStages()):
                with tracer.span(f"transform:{type(stage).__name__}", stage=i):
                    table = stage.transform(table)
        if observe:
            monitor.observe_columns({
                c: table.column(c) for c in table.columns if c not in in_cols
            })
        return table

    def transform_schema(self, schema: Dict[str, Any]) -> Dict[str, Any]:
        return _chain_schema(self.getStages(), schema)


def _label_contract(stages: List[PipelineStage]) -> tuple:
    """Best-effort (label column, label domain) for the fit guard: the
    last estimator stage exposing ``getLabelCol`` names the label, and a
    class name carrying ``Classifier`` pins the non-negative-integer
    domain. Unknown graphs guard features only."""
    label_col, domain = None, None
    for stage in stages:
        if not isinstance(stage, Estimator):
            continue
        getter = getattr(stage, "getLabelCol", None)
        if getter is None:
            continue
        try:
            label_col = getter()
        except (AttributeError, KeyError, ValueError):
            continue
        domain = "classifier" if "Classifier" in type(stage).__name__ else None
    return label_col, domain


def _chain_schema(stages: List[PipelineStage], source: Any) -> Dict[str, Any]:
    """Thread a schema through a stage list, re-tagging errors with the
    failing stage's position + class so pipeline users see *which* stage
    is mis-wired, not just which column."""
    from mmlspark_tpu_torch.core.schema import SchemaError, as_schema

    schema = as_schema(source)
    for i, stage in enumerate(stages):
        label = f"{i} ({type(stage).__name__})"
        try:
            schema = stage.transform_schema(schema)
        except SchemaError as e:
            raise e.with_stage(label) from None
        schema = as_schema(schema)
    return schema


def make_pipeline_model(*stages: Transformer) -> PipelineModel:
    """Assemble transformers into an anonymous PipelineModel
    (``NamespaceInjections.pipelineModel``)."""
    return PipelineModel(stages=list(stages))


def ml_transform(table: Table, *stages: Transformer) -> Table:
    """``df.mlTransform(t1, t2)`` fluent sugar (``core/spark/FluentAPI.scala``)."""
    for s in stages:
        table = s.transform(table)
    return table
